"""The port's privacy subsystem against the JAX package's, on the CPU:
windowed async SecAgg (``core/privacy/{masking,secagg_window}.py`` over the
port's FedBuff buffer), the accounted DP fold (``core/privacy/dp.py``,
``core/dp/budget_accountant``), the finite-field toolbox
(``core/mpc/finite_field.py``) and the config and comm-boundary gates.

The same numpy-seeded inputs go into both packages. Tolerances:

- masking, the ring sum and every publish of a window (full, after a
  dropout's reveals, on a shared sparse support, through the
  edge->regional->root tree with tier masks): bit-equal to JAX's, and to
  the host reference ``dequantize_sum(center_ring(sum of quantize_vector))``,
  for the same member RNG seeds (the masks are integers below 2^24 in f32,
  so the fold is exact in any order); beyond the ring a tree is refused
  where JAX publishes a wrong mean (R5, shown on both sides);
- the flat vector every mask indexes: the port's state dict flattened in the
  JAX wire layout (``models/convert.py`` ``wire_vector``) equal to JAX's
  ``tree_flatten_to_vector`` of the flax tree, bit for bit;
- the RDP accountant's epsilon: within 1e-12 of JAX's (the same host math);
- DP noise (flat and at a tree's root): no PRNG matches across frameworks,
  so its statistics: the std of the published noise within 5% of z·C/n
  (tests/test_privacy.py's limit) and its mean within 4 sigma/sqrt(d) of 0;
- ``clip_update``/``clip_to_reference``: within the ball the input itself;
  outside, within one f32 ulp of JAX's (the port sums the norm in f64 on
  the leaves' device, JAX on the host, in another order).

Torch is pinned to one thread: the driver runs the suite under several
workers.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.aggregation.async_buffer import AsyncAggBuffer as JBuffer
from fedml_tpu.core.aggregation.async_buffer import StalenessPolicy as JPolicy
from fedml_tpu.core.dp.budget_accountant import rdp_accountant as jrdp
from fedml_tpu.core.mpc import finite_field as jff
from fedml_tpu.core import privacy as jpriv
from fedml_tpu.core.privacy import masking as jmask
from fedml_tpu.utils.pytree import tree_flatten_to_vector
from fedml_tpu_torch.core import telemetry as tel
from fedml_tpu_torch.core.aggregation.async_buffer import AsyncAggBuffer, StalenessPolicy
from fedml_tpu_torch.core.dp.budget_accountant import rdp_accountant as trdp
from fedml_tpu_torch.core.mpc import finite_field as tff
from fedml_tpu_torch.core import privacy as tpriv
from fedml_tpu_torch.core.privacy import masking as tmask
from fedml_tpu_torch.core.privacy import secagg_window as twin
from fedml_tpu_torch.models.convert import (params_from_jax, params_to_jax,
                                            state_from_wire_vector, wire_vector)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# a flax tree with a Conv (HWIO) and a Dense ([in, out]) kernel: the layouts
# and the name order differ from the port's, so every vector below checks
# the wire layout too
SHAPES = {"Conv_0": {"kernel": (3, 3, 2, 4), "bias": (4,)},
          "Dense_0": {"kernel": (6, 5), "bias": (5,)}}
D = 3 * 3 * 2 * 4 + 4 + 6 * 5 + 5
# the port's module order (Dense registered first), not flax's name order
PORT_ORDER = ["Dense_0.weight", "Dense_0.bias", "Conv_0.weight", "Conv_0.bias"]


def _jtree(rng, scale=1.0):
    return {m: {k: (rng.normal(0, scale, s)).astype(np.float32) for k, s in leaves.items()}
            for m, leaves in SHAPES.items()}


def _to_port(jtree):
    sd = params_from_jax(jtree)
    return {k: sd[k] for k in PORT_ORDER}


def _jflat(tree):
    return np.asarray(tree_flatten_to_vector(tree)[0])


def _pflat(state):
    return wire_vector(state).numpy()


def _jtemplate():
    return {m: {k: jnp.zeros(s, jnp.float32) for k, s in leaves.items()}
            for m, leaves in SHAPES.items()}


def _ptemplate():
    return _to_port({m: {k: np.zeros(s, np.float32) for k, s in leaves.items()}
                     for m, leaves in SHAPES.items()})


def _deltas(n, seed):
    rng = np.random.default_rng(seed)
    return [_jtree(rng) for _ in range(n)]


def _pair(n, seed, **kw):
    """A JAX coordinator over JAX's buffer and the port's over its own, both
    from ``np.random.default_rng(seed)``: the same nonces and member keys."""
    jbuf = JBuffer(publish_k=n, policy=JPolicy(exponent=0.0))
    jco = jpriv.WindowCoordinator(jbuf, _jtemplate(), rng=np.random.default_rng(seed), **kw)
    pbuf = AsyncAggBuffer(publish_k=n, policy=StalenessPolicy(exponent=0.0))
    pco = tpriv.WindowCoordinator(pbuf, _ptemplate(), rng=np.random.default_rng(seed), **kw)
    return (jbuf, jco), (pbuf, pco)


def _honest(vecs, spec, n=None):
    n = len(vecs) if n is None else n
    qsum = sum(tmask.quantize_vector(v, spec) for v in vecs)
    return tmask.dequantize_sum(tmask.center_ring(np.mod(qsum, spec.ring), spec), n, spec)


def _assert_port_equals_jax_tree(port_state, jax_tree):
    got = params_to_jax(port_state)
    for m, leaves in jax_tree.items():
        for k, v in leaves.items():
            assert np.array_equal(got[m][k], np.asarray(v)), (m, k)


# --- the flat wire vector ---------------------------------------------------------

def test_wire_vector_is_jax_flatten_of_the_flax_tree():
    jt = _jtree(np.random.default_rng(0))
    state = _to_port(jt)
    assert np.array_equal(_pflat(state), _jflat(jt))
    back = state_from_wire_vector(torch.from_numpy(_jflat(jt).copy()), state)
    assert list(back) == PORT_ORDER
    assert all(torch.equal(back[k], state[k]) and back[k].is_contiguous() for k in state)


def test_wire_vector_of_resnet56_is_jax_flatten():
    """ResNet-56 at full width: 855,770 coordinates, the port's state dict
    flattened in the wire layout equal to JAX's flatten of its flax tree."""
    import fedml_tpu_torch

    args = fedml_tpu_torch.default_config("simulation", model="resnet56", dataset="cifar10",
                                          random_seed=0, using_gpu=False)
    model = fedml_tpu_torch.model.create(args, 10, device="cpu")
    state = {k: v.detach() for k, v in model.module.state_dict().items()}
    flat = _pflat(state)
    assert flat.size == 855_770
    assert np.array_equal(flat, _jflat(params_to_jax(state)))
    back = state_from_wire_vector(torch.from_numpy(flat), state)
    assert list(back) == list(state) and all(torch.equal(back[k], state[k]) for k in state)


# --- finite field --------------------------------------------------------------

P = tff.DEFAULT_PRIME


@pytest.mark.parametrize("case", ["mod_inverse", "field_div", "lagrange", "shamir", "dh",
                                  "quantize"])
def test_finite_field_matches_jax(case):
    rng = np.random.default_rng(3)
    a = rng.integers(1, P, size=64)
    b = rng.integers(1, P, size=64)
    if case == "mod_inverse":
        assert np.array_equal(tff.mod_inverse(a, P), jff.mod_inverse(a, P))
        assert np.all((tff.mod_inverse(a, P) * a) % P == 1)
    elif case == "field_div":
        assert np.array_equal(tff.field_div(a, b, P), jff.field_div(a, b, P))
    elif case == "lagrange":
        alpha, beta = np.arange(20, 26), np.arange(1, 9)
        assert np.array_equal(tff.lagrange_coeffs(alpha, beta, P),
                              jff.lagrange_coeffs(alpha, beta, P))
    elif case == "shamir":
        secret = rng.integers(0, P, size=3)
        shares = tff.shamir_share(secret, 7, 3, P, np.random.default_rng(5))
        assert np.array_equal(shares, jff.shamir_share(secret, 7, 3, P, np.random.default_rng(5)))
        for idx in ([0, 1, 2, 3], [6, 4, 2, 1], [0, 1, 2, 3, 4, 5, 6]):
            assert np.array_equal(tff.shamir_reconstruct(shares[idx], idx, P), secret)
            assert np.array_equal(jff.shamir_reconstruct(shares[idx], idx, P), secret)
    elif case == "dh":
        sk1, sk2 = 123456789, 987654321
        pk1, pk2 = tff.dh_public_key(sk1, P), tff.dh_public_key(sk2, P)
        assert (pk1, pk2) == (jff.dh_public_key(sk1, P), jff.dh_public_key(sk2, P))
        assert tff.dh_shared_key(sk1, pk2, P) == tff.dh_shared_key(sk2, pk1, P) \
            == jff.dh_shared_key(sk1, pk2, P)
    else:
        x = rng.normal(0, 3, size=128)
        q = tff.quantize(x, 16, P)
        assert np.array_equal(q, jff.quantize(x, 16, P))
        assert np.array_equal(tff.dequantize(q, 16, P), jff.dequantize(q, 16, P))


@pytest.mark.parametrize("threshold", [1, 4, 8, 15])
def test_shamir_reconstructs_at_every_threshold(threshold):
    """Any threshold+1 of 16 shares give the secret back. The JAX package's
    ``shamir_reconstruct`` sums the products in one int64 dot product, which
    can wrap from three shares on (each product is below 2^62; ROADMAP.md,
    Queue 3); the port's reduces each
    product mod p first, so the two agree wherever the JAX sum does not
    wrap (the parametrized case above)."""
    rng = np.random.default_rng(threshold)
    for _ in range(20):
        secret = rng.integers(0, P, size=2)
        shares = tff.shamir_share(secret, 16, threshold, P, rng)
        idx = sorted(rng.choice(16, threshold + 1, replace=False).tolist())
        assert np.array_equal(tff.shamir_reconstruct(shares[idx], idx, P), secret)


# --- the ring's contract --------------------------------------------------------

@pytest.mark.parametrize("fanin,members,qbits", [(1, 1, 13), (4, 4, 13), (16, 16, 13),
                                                 (16, 16, 15), (64, 64, 13), (2, 200, 13)])
def test_ring_bits_for_matches_jax(fanin, members, qbits):
    try:
        want = jmask.ring_bits_for(fanin, members, qbits)
    except ValueError as e:
        with pytest.raises(ValueError, match="no exact masking ring"):
            tmask.ring_bits_for(fanin, members, qbits)
        assert "no exact masking ring" in str(e)
        return
    assert tmask.ring_bits_for(fanin, members, qbits) == want


@pytest.mark.parametrize("ring_bits,fanin,members", [(20, 16, 16), (15, 4, 4), (23, 4, 4),
                                                     (18, 2, 2)])
def test_validate_ring_bits_matches_jax(ring_bits, fanin, members):
    tspec, jspec = tmask.QuantSpec(ring_bits=ring_bits), jmask.QuantSpec(ring_bits=ring_bits)
    try:
        jmask.validate_ring_bits(jspec, fanin, members)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmask.validate_ring_bits(tspec, fanin, members)
        assert str(got.value) == str(e)
        return
    tmask.validate_ring_bits(tspec, fanin, members)


def test_ring_helpers_match_jax():
    spec_t, spec_j = tmask.QuantSpec(ring_bits=20), jmask.QuantSpec(ring_bits=20)
    x = np.random.default_rng(1).normal(0, 2, size=500).astype(np.float32)
    assert np.array_equal(tmask.quantize_vector(x, spec_t), jmask.quantize_vector(x, spec_j))
    r = np.random.default_rng(2).integers(-3 * 2**20, 3 * 2**20, size=500).astype(np.float64)
    assert np.array_equal(tmask.center_ring(r, spec_t), jmask.center_ring(r, spec_j))
    assert np.array_equal(tmask.dequantize_sum(r, 7, spec_t), jmask.dequantize_sum(r, 7, spec_j))
    assert tmask.pair_seed(11, 12345) == jmask.pair_seed(11, 12345)
    assert np.array_equal(tmask.prg_ring(99, 300, spec_t), jmask.prg_ring(99, 300, spec_j))
    seeds = {3: 17, 5: 23, 0: 31}
    assert np.array_equal(tmask.pairwise_mask_sum(2, seeds, 50, spec_t),
                          jmask.pairwise_mask_sum(2, seeds, 50, spec_j))


# --- windows: the port's coordinator over its buffer against JAX's -------------------

def test_masks_cancel_bit_exact():
    n = 4
    spec = tmask.QuantSpec(ring_bits=tmask.ring_bits_for(n, n))
    deltas = [_to_port(t) for t in _deltas(n, 7)]
    buf = AsyncAggBuffer(publish_k=n, policy=StalenessPolicy(exponent=0.0))
    co = tpriv.WindowCoordinator(buf, _ptemplate(), spec=spec, rng=np.random.default_rng(1))
    _, members = co.open_window(range(n))
    for r in range(n):
        assert co.submit(r, members[r].mask(_pflat(deltas[r])), client_version=buf.version) \
            == "accept"
    out = buf.publish()
    assert list(out) == PORT_ORDER and out["Conv_0.weight"].shape == (4, 2, 3, 3)
    assert np.array_equal(_pflat(out), _honest([_pflat(d) for d in deltas], spec))


def test_masked_vectors_equal_jax_for_the_same_member_seeds():
    n = 5
    spec = dict(spec=jmask.QuantSpec(ring_bits=jmask.ring_bits_for(n, n)))
    (_, jco), (_, pco) = _pair(n, 21, **spec)
    jwin, jm = jco.open_window(range(n))
    pwin, pm = pco.open_window(range(n))
    assert (pwin.window_id, pwin.nonce, pwin.threshold) == (jwin.window_id, jwin.nonce,
                                                            jwin.threshold)
    for r, jt in enumerate(_deltas(n, 8)):
        pv = pm[r].mask(_pflat(_to_port(jt)))
        jv = jm[r].mask(_jflat(jt))
        assert pv.dtype == np.float32 and np.array_equal(pv, jv)
        # the wire value is not the member's quantized vector
        q = tmask.quantize_vector(_jflat(jt), pco.spec)
        assert not np.array_equal(pv, np.mod(q, pco.spec.ring))


def test_full_window_publish_equals_jax():
    n = 4
    (jbuf, jco), (pbuf, pco) = _pair(n, 5)
    _, jm = jco.open_window(range(n))
    _, pm = pco.open_window(range(n))
    deltas = _deltas(n, 9)
    for r in (2, 0, 3, 1):  # any arrival order: the ring sum is exact
        assert jco.submit(r, jm[r].mask(_jflat(deltas[r])), client_version=jbuf.version) \
            == pco.submit(r, pm[r].mask(_pflat(_to_port(deltas[r]))),
                          client_version=pbuf.version) == "accept"
    jout, pout = jbuf.publish(), pbuf.publish()
    _assert_port_equals_jax_tree(pout, jout)
    assert np.array_equal(_pflat(pout), _honest([_jflat(d) for d in deltas], pco.spec))
    assert pbuf.version == jbuf.version == 1


def test_dropout_with_reveals_equals_jax():
    n, dead = 5, 3
    (jbuf, jco), (pbuf, pco) = _pair(n, 9, threshold=2)
    jwin, jm = jco.open_window(range(n))
    pwin, pm = pco.open_window(range(n))
    deltas = _deltas(n, 11)
    survivors = [r for r in range(n) if r != dead]
    t = tel.get_telemetry()
    c0 = {c: t.counter(c).value for c in (twin.DROPOUT_COUNTER, twin.RECOVERED_COUNTER,
                                          twin.REVEAL_COUNTER)}
    for r in survivors:
        jco.submit(r, jm[r].mask(_jflat(deltas[r])), client_version=jbuf.version)
        pco.submit(r, pm[r].mask(_pflat(_to_port(deltas[r]))), client_version=pbuf.version)
    # the reveals as the message plane carries them: survivor -> {dropped: share}
    reveals = {s: pm[s].reveal_shares([dead]) for s in survivors}
    assert reveals == {s: jm[s].reveal_shares([dead]) for s in survivors}
    assert pco.recover(reveals=reveals) == jco.recover(members=jm) == [dead]
    pout, jout = pco.close_window(), jco.close_window()
    _assert_port_equals_jax_tree(pout, jout)
    assert np.array_equal(_pflat(pout), _honest([_jflat(deltas[r]) for r in survivors], pco.spec))
    assert pwin.recovered and jwin.recovered and pwin.closed
    assert t.counter(twin.DROPOUT_COUNTER).value == c0[twin.DROPOUT_COUNTER] + 1
    assert t.counter(twin.RECOVERED_COUNTER).value == c0[twin.RECOVERED_COUNTER] + 1
    assert t.counter(twin.REVEAL_COUNTER).value == c0[twin.REVEAL_COUNTER] + len(survivors)
    assert pco.statusz()["recovered_total"] == 1 and pco.statusz()["dropouts_total"] == 1


def test_sixteen_member_window_recovers_a_dropout_at_threshold_8():
    """The card smoke's cohort: 16 members, threshold 8, one dropout: the 9
    reveals reconstruct its key and the survivors' publish is bit-equal to
    their host reference."""
    n, dead = 16, 15
    buf = AsyncAggBuffer(publish_k=n, policy=StalenessPolicy(exponent=0.0))
    co = tpriv.WindowCoordinator(buf, _ptemplate(), spec=tpriv.PrivacyConfig().quant_spec(n, n),
                                 threshold=8, rng=np.random.default_rng(16))
    _, members = co.open_window(range(n))
    deltas = [_to_port(t) for t in _deltas(n, 23)]
    for r in range(n - 1):
        co.submit(r, members[r].mask(_pflat(deltas[r])), client_version=0)
    survivors = list(range(n - 1))
    reveals = {s: members[s].reveal_shares([dead]) for s in survivors[:9]}
    assert co.recover(reveals=reveals) == [dead]
    out = co.close_window()
    assert np.array_equal(_pflat(out), _honest([_pflat(deltas[r]) for r in survivors], co.spec))


def test_below_threshold_reveal_fails_as_in_jax():
    n = 4
    (jbuf, jco), (pbuf, pco) = _pair(n, 6, threshold=2)
    _, jm = jco.open_window(range(n))
    _, pm = pco.open_window(range(n))
    deltas = _deltas(n, 17)
    for r in (0, 1):
        jco.submit(r, jm[r].mask(_jflat(deltas[r])), client_version=jbuf.version)
        pco.submit(r, pm[r].mask(_pflat(_to_port(deltas[r]))), client_version=pbuf.version)
    with pytest.raises(RuntimeError, match="reveal quorum"):
        jco.recover(members={r: jm[r] for r in (0, 1)})
    with pytest.raises(RuntimeError, match="reveal quorum"):
        pco.recover(members={r: pm[r] for r in (0, 1)})


def test_abort_discards_the_epoch_as_in_jax():
    n = 3
    (jbuf, jco), (pbuf, pco) = _pair(n, 14)
    _, jm = jco.open_window(range(n))
    pwin, pm = pco.open_window(range(n))
    deltas = _deltas(n, 21)
    f0 = tel.get_telemetry().counter(twin.WINDOWS_FAILED_COUNTER).value
    assert pco.submit(0, pm[0].mask(_pflat(_to_port(deltas[0]))), client_version=0) == \
        jco.submit(0, jm[0].mask(_jflat(deltas[0])), client_version=0) == "accept"
    assert sorted(pco.abort_window()) == sorted(jco.abort_window()) == [1, 2]
    assert pco.window is None and pwin.closed and pco.failed_total == 1
    assert pbuf.version == jbuf.version == 0 and pbuf.depth() == 0
    assert pbuf.publish() is None and jbuf.publish() is None
    assert tel.get_telemetry().counter(twin.WINDOWS_FAILED_COUNTER).value == f0 + 1
    assert pco.submit(1, pm[1].mask(_pflat(_to_port(deltas[1]))), client_version=0) == \
        jco.submit(1, jm[1].mask(_jflat(deltas[1])), client_version=0) == twin.WINDOW_CLOSED
    window2, _ = pco.open_window(range(n))
    assert not window2.closed


def test_window_verdicts_match_jax():
    """The same submit script into both: a stale window id, a rank outside
    the cohort, a fresh arrival, a duplicate rank's second submit after the
    publish (window closed)."""
    n = 3
    (jbuf, jco), (pbuf, pco) = _pair(n, 12)
    jwin, jm = jco.open_window([1, 2, 3])
    _, pm = pco.open_window([1, 2, 3])
    deltas = _deltas(4, 19)
    script = [(1, jwin.window_id + 1), (0, None), (1, jwin.window_id), (2, None), (3, None),
              (2, jwin.window_id)]
    got, want = [], []
    for r, wid in script:
        src = deltas[r]
        pvec = pm[r].mask(_pflat(_to_port(src))) if r in pm else np.zeros(D, np.float32)
        jvec = jm[r].mask(_jflat(src)) if r in jm else np.zeros(D, np.float32)
        got.append(pco.submit(r, pvec, client_version=0, window_id=wid))
        want.append(jco.submit(r, jvec, client_version=0, window_id=wid))
        if pco.window is not None and pco.window.complete() and not pco.window.closed:
            pbuf.publish()
            jbuf.publish()
    assert got == want == [twin.WINDOW_CLOSED, "stale_rejected", "accept", "accept", "accept",
                           twin.WINDOW_CLOSED]


def test_support_composition_equals_jax():
    n = 4
    (jbuf, jco), (pbuf, pco) = _pair(n, 41, support_ratio=0.25)
    _, jm = jco.open_window(range(n))
    _, pm = pco.open_window(range(n))
    assert np.array_equal(pco.support, jco.support)
    k = len(pco.support)
    assert k == int(np.ceil(0.25 * D)) and pco.d == k and pco.full_d == D
    deltas = _deltas(n, 37)
    for r in range(n):
        pp = tpriv.masked_uplink_payload(pm[r], _to_port(deltas[r]), support=pco.support)
        jp = jpriv.masked_uplink_payload(jm[r], deltas[r], support=jco.support)
        assert tpriv.is_masked_payload(pp) and pp["masked"].shape == (k,)
        assert np.array_equal(pp["masked"], jp["masked"]) and pp["window_id"] == jp["window_id"]
        assert tpriv.submit_masked_payload(pco, pp, client_version=0) == \
            jpriv.submit_masked_payload(jco, jp, client_version=0) == "accept"
    pout, jout = pbuf.publish(), jbuf.publish()
    _assert_port_equals_jax_tree(pout, jout)
    flat = _pflat(pout)
    sup = np.asarray(pco.support)
    want = _honest([_jflat(d)[sup] for d in deltas], pco.spec)
    assert np.array_equal(flat[sup], want)
    assert np.all(flat[np.setdiff1d(np.arange(D), sup)] == 0.0)


def test_support_is_drawn_from_the_window_nonce():
    supports = []
    for seed in (1, 2):
        buf = AsyncAggBuffer(publish_k=3, policy=StalenessPolicy(exponent=0.0))
        co = tpriv.WindowCoordinator(buf, _ptemplate(), support_ratio=0.5,
                                     rng=np.random.default_rng(seed))
        window, _ = co.open_window(range(3))
        from fedml_tpu_torch.utils.compression import secagg_support

        assert np.array_equal(co.support, secagg_support(window.nonce, D, 0.5))
        supports.append(tuple(co.support.tolist()))
    assert supports[0] != supports[1]


def test_counters_count_windows_and_masked_merges():
    n = 3
    t = tel.get_telemetry()
    w0, m0 = t.counter(twin.WINDOWS_COUNTER).value, t.counter(twin.MASKED_MERGE_COUNTER).value
    buf = AsyncAggBuffer(publish_k=n, policy=StalenessPolicy(exponent=0.0))
    co = tpriv.WindowCoordinator(buf, _ptemplate(), rng=np.random.default_rng(5))
    _, members = co.open_window(range(n))
    for r, d in enumerate(_deltas(n, 1)):
        co.submit(r, members[r].mask(_pflat(_to_port(d))), client_version=0)
    assert buf.publish() is not None
    assert t.counter(twin.WINDOWS_COUNTER).value == w0 + 1
    assert t.counter(twin.MASKED_MERGE_COUNTER).value == m0 + n
    doc = co.statusz()
    assert doc["windows_total"] == 1 and doc["spec"] == co.spec.as_dict()


def test_nonzero_staleness_exponent_rejected():
    with pytest.raises(ValueError, match="exponent=0"):
        tpriv.WindowCoordinator(AsyncAggBuffer(publish_k=2), _ptemplate())


def _trees(n_edges, per_edge, fanout=2):
    """The same tree in both packages (exponent 0, the port's on the CPU)."""
    from fedml_tpu.core.distributed.hierarchy import HierarchyTree as JTree
    from fedml_tpu_torch.core.distributed.hierarchy import HierarchyTree as TTree

    jtree = JTree.build(n_edges=n_edges, regional_fanout=fanout, publish_k=per_edge,
                        policy=JPolicy(exponent=0.0))
    ttree = TTree.build(n_edges=n_edges, regional_fanout=fanout, publish_k=per_edge,
                        policy=StalenessPolicy(exponent=0.0), device="cpu")
    return jtree, ttree


def _cohorts(tree, per_edge):
    return {e.name: list(range(i * per_edge, (i + 1) * per_edge))
            for i, e in enumerate(tree.edges)}


def _drive(tree, hp, cohorts, flat_of_rank):
    """JAX's TestHierarchyPrivacy._drive: each edge's window opened, every
    member masks and submits through its edge coordinator, the edge
    publishes (and the cascade forwards)."""
    opened = hp.open_edge_windows(cohorts)
    for e in tree.edges:
        members = opened[e.name][1]
        for r in cohorts[e.name]:
            v = e.privacy.submit(r, members[r].mask(flat_of_rank(r)),
                                 client_version=e.buffer.version)
            assert v == "accept"
        e._maybe_publish()


def _hier_pair(n_edges, per_edge, deltas, seed, fanout=2, spy=False):
    """Drive one tree per package from ``np.random.default_rng(seed)``;
    returns (jax out, port out, jax hp, port hp, upward vectors)."""
    jtree, ttree = _trees(n_edges, per_edge, fanout)
    jhp = jpriv.HierarchyPrivacy(jtree, _jtemplate(), rng=np.random.default_rng(seed))
    thp = tpriv.HierarchyPrivacy(ttree, _ptemplate(), rng=np.random.default_rng(seed))
    seen = {"jax": {}, "torch": {}}
    if spy:
        for key, tree in (("jax", jtree), ("torch", ttree)):
            for e in tree.edges:
                orig = e.parent._submit_from_child

                def wrap(child, weight, model, _orig=orig, _name=e.name, _d=seen[key]):
                    _d[_name] = np.array(_np_of(model), copy=True)
                    return _orig(child, weight, model)

                e.parent._submit_from_child = wrap
    _drive(jtree, jhp, _cohorts(jtree, per_edge), lambda r: _jflat(deltas[r]))
    _drive(ttree, thp, _cohorts(ttree, per_edge), lambda r: _pflat(_to_port(deltas[r])))
    assert jtree.version == ttree.version == 1
    return jtree.latest_model(), ttree.latest_model(), jhp, thp, seen


def _np_of(model):
    if isinstance(model, dict):  # the port's masked leaf
        return model[twin.MASKED_LEAF].numpy()
    return np.asarray(model)


@pytest.mark.parametrize("what", ["HierarchyPrivacy", "coordinator_tier_key",
                                  "member_tier_key"])
def test_hierarchical_masking_is_refused(what):
    """Hierarchical masking runs (these three were refusals until the
    hierarchy came): HierarchyPrivacy over a tree, an edge coordinator's
    tier key and a member's tier mask, each bit-equal to JAX's for the same
    seeds. What stays refused is a tree beyond its ring (R5,
    test_r5_root_window_beyond_the_ring_is_refused_where_jax_publishes_garbage)."""
    if what == "HierarchyPrivacy":
        jtree, ttree = _trees(4, 3)
        jhp = jpriv.HierarchyPrivacy(jtree, _jtemplate(), rng=np.random.default_rng(2))
        thp = tpriv.HierarchyPrivacy(ttree, _ptemplate(), rng=np.random.default_rng(2))
        assert sorted(thp.edge_coordinators) == sorted(jhp.edge_coordinators)
        for name, co in thp.edge_coordinators.items():
            jco = jhp.edge_coordinators[name]
            assert co.tier_key == jco.tier_key and co.tier_name == name
            assert co.ledger is thp.ledger and ttree.edges[int(name[5:])].privacy is co
        assert thp.max_members == 2 * 2 * 3 and thp.statusz()["ledger_depth"] == 0
        assert type(ttree.regionals[0].privacy).__name__ == "_RingPassThrough"
        assert ttree.root.privacy is thp.root_unmasker
        with pytest.raises(ValueError, match="exponent=0"):
            tpriv.HierarchyPrivacy(
                _tree_at_exponent_half(), _ptemplate(), rng=np.random.default_rng(2))
    elif what == "coordinator_tier_key":
        n, key = 3, 7
        outs = []
        for pkg, buf, tmpl, flat in (
                (jpriv, JBuffer(publish_k=n, policy=JPolicy(exponent=0.0)), _jtemplate(), _jflat),
                (tpriv, AsyncAggBuffer(publish_k=n, policy=StalenessPolicy(exponent=0.0)),
                 _ptemplate(), lambda d: _pflat(_to_port(d)))):
            ledger = []
            co = pkg.WindowCoordinator(buf, tmpl, tier_name="edge-0", tier_key=key,
                                       ledger=ledger, max_fanin=4,
                                       rng=np.random.default_rng(13))
            _, members = co.open_window(range(n))
            for r, d in enumerate(_deltas(n, 17)):
                co.submit(r, members[r].mask(flat(d)), client_version=0)
            outs.append((_np_of(buf.publish()), ledger, co.statusz()["tier"]))
        (jout, jled, jtier), (tout, tled, ttier) = outs
        assert np.array_equal(tout, jout) and tled == jled and ttier == jtier == "edge-0"
        assert tled[0]["ranks"] == [0, 1, 2] and tled[0]["n"] == n
        # still masked: the ring residue is not the honest sum's residue
        q = sum(tmask.quantize_vector(_jflat(d), tmask.QuantSpec()) for d in _deltas(n, 17))
        assert not np.array_equal(tout, np.mod(q, tmask.QuantSpec().ring).astype(np.float32))
    else:
        spec, nonce, cohort = tmask.QuantSpec(), 99, [0, 1]
        vecs = []
        for pkg in (tpriv, jpriv):
            ms = {r: pkg.WindowMember(r, 0, nonce, cohort, spec, 1, tier_key=7,
                                      rng=np.random.default_rng(30 + r)) for r in cohort}
            pks = {r: m.public_key for r, m in ms.items()}
            for m in ms.values():
                m.install_directory(pks)
            vecs.append(ms[0].mask(_jflat(_deltas(1, 3)[0])))
        assert np.array_equal(vecs[0], vecs[1])
        plain = twin.WindowMember(0, 0, nonce, cohort, spec, 1, rng=np.random.default_rng(30))
        plain.install_directory(pks)
        tier = tmask.prg_ring(tmask.tier_seed(7, nonce, 0), D, spec)
        assert np.array_equal(np.mod(vecs[0].astype(np.float64) - tier, spec.ring),
                              plain.mask(_jflat(_deltas(1, 3)[0])))


def _tree_at_exponent_half():
    """A tree under the default staleness policy (exponent 0.5)."""
    from fedml_tpu_torch.core.distributed.hierarchy import HierarchyTree as TTree

    return TTree.build(n_edges=2, publish_k=2, device="cpu")


def test_three_tier_window_equals_flat_and_jax():
    """JAX's test_three_tier_equals_flat (4 edges x 3, regional_fanout 2) in
    both packages from one rng: the root publish bit-equal to JAX's and to
    the honest quantized mean of the 12 deltas; the ledger drained."""
    deltas = _deltas(12, 23)
    jout, tout, jhp, thp, _ = _hier_pair(4, 3, deltas, 11)
    _assert_port_equals_jax_tree(tout, jout)
    assert np.array_equal(_pflat(tout), _honest([_jflat(d) for d in deltas], thp.spec))
    assert len(thp.ledger) == len(jhp.ledger) == 0


def test_intermediate_tiers_never_see_plaintext():
    """What an edge publishes upward stays in the tier ring until the root
    strips it (JAX's test): nonnegative ring residues, far from the honest
    partial mean, and bit-equal to JAX's upward vectors."""
    deltas = _deltas(6, 29)
    deltas = [{m: {k: (0.5 * v).astype(np.float32) for k, v in leaves.items()}
               for m, leaves in d.items()} for d in deltas]
    jout, tout, jhp, thp, seen = _hier_pair(2, 3, deltas, 31, spy=True)
    assert set(seen["torch"]) == set(seen["jax"]) == {"edge-0", "edge-1"}
    for i, name in enumerate(("edge-0", "edge-1")):
        honest = _honest([_jflat(deltas[r]) for r in range(3 * i, 3 * i + 3)], thp.spec)
        up = seen["torch"][name]
        assert np.array_equal(up, seen["jax"][name]) and up.dtype == np.float32
        assert np.all(up >= 0)
        assert not np.allclose(up, honest, atol=thp.spec.clip)
    _assert_port_equals_jax_tree(tout, jout)


def test_dp_root_noise_matches_its_sigma():
    """A DP root: all-zero updates through 2 edges x 2 members, so the root
    publish is the noise alone, std z·C/n over the 4 members (the flat
    window's statistics test)."""
    from fedml_tpu_torch.core.distributed.hierarchy import HierarchyTree as TTree

    z, clip = 0.8, 1.0
    tree = TTree.build(n_edges=2, regional_fanout=2, publish_k=2,
                       policy=StalenessPolicy(exponent=0.0), device="cpu")
    dp = tpriv.DPFold(noise_multiplier=z, l2_clip=clip, seed=3)
    hp = tpriv.HierarchyPrivacy(tree, {"w": torch.zeros(NOISE_D)}, dp=dp,
                                rng=np.random.default_rng(4))
    _drive(tree, hp, _cohorts(tree, 2), lambda r: np.zeros(NOISE_D, np.float32))
    _noise_stats(tree.latest_model()["w"].numpy(), z * clip / 4)
    assert dp.accountant.steps == 1


def test_r5_root_window_beyond_the_ring_is_refused_where_jax_publishes_garbage():
    """ROADMAP.md Queue 3, R5. JAX's ``WindowCoordinator.open_window``
    (fedml_tpu/core/privacy/secagg_window.py:322) checks the ring against
    one edge's cohort only, and ``_RootUnmasker.on_publish`` sums every
    edge's members (``n_total``, :621) with no check against the ring. At 8
    edges x 16 members (regional_fanout 4: 2 x 4 x 16 = 128 members, 21
    bits against the default 20-bit ring) with every coordinate at 2.9,
    JAX's root publishes about -0.1 where the honest quantized mean is
    2.9000244; the port refuses that tree at construction, as the flat
    coordinator refuses a 128-member window. At 4 x 4 both are bit-equal
    to the honest mean."""
    spec = tmask.QuantSpec()

    def const(n):
        return [{m: {k: np.full(sh, 2.9, np.float32) for k, sh in leaves.items()}
                 for m, leaves in SHAPES.items()} for _ in range(n)]

    def honest(deltas):
        q = sum(tmask.quantize_vector(_jflat(d), spec) for d in deltas)
        return tmask.dequantize_sum(q, len(deltas), spec)

    deltas = const(128)
    jtree, ttree = _trees(8, 16, fanout=4)
    jhp = jpriv.HierarchyPrivacy(jtree, _jtemplate(), rng=np.random.default_rng(5))
    _drive(jtree, jhp, _cohorts(jtree, 16), lambda r: _jflat(deltas[r]))
    jroot = _jflat(jtree.latest_model())
    ref = honest(deltas)
    assert np.allclose(ref, 2.9000244, atol=1e-6)
    assert np.all(np.abs(jroot - ref) > 2.0)  # JAX: wrapped, every coordinate
    with pytest.raises(ValueError, match="128 members.*ring_bits=20 too small"):
        tpriv.HierarchyPrivacy(ttree, _ptemplate(), rng=np.random.default_rng(5))
    with pytest.raises(ValueError, match="ring_bits=20 too small"):
        twin.validate_ring_bits(spec, 16, 128)  # the flat window's refusal
    # a cohort wider than its edge's window is held to the same bound
    jtree, ttree = _trees(2, 2)
    thp = tpriv.HierarchyPrivacy(ttree, _ptemplate(), rng=np.random.default_rng(5))
    with pytest.raises(ValueError, match="too small"):
        thp.open_edge_windows({"edge-0": list(range(64))})
    # within the ring both packages are bit-equal to the honest mean
    deltas = const(16)
    jout, tout, _, _, _ = _hier_pair(4, 4, deltas, 5)
    _assert_port_equals_jax_tree(tout, jout)
    assert np.array_equal(_pflat(tout), honest(deltas))


def test_tf32_matmuls_refused_for_a_card_fold():
    """The check reads the flag only (no card needed): a CUDA fold with TF32
    matmuls on would round the ring values, so the window refuses it."""
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            twin._require_exact_fold(torch.device("cuda"))
        twin._require_exact_fold(torch.device("cpu"))
        torch.backends.cuda.matmul.allow_tf32 = False
        twin._require_exact_fold(torch.device("cuda"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def test_buffer_discard_and_plain_path_untouched():
    """Without a session the buffer publishes as before (the exponent-0,
    one-bucket publish bit-equal to engine.aggregate); discard drops an
    epoch without a version bump."""
    rng = np.random.default_rng(47)
    trees = [{"w": torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))}
             for _ in range(3)]
    buf = AsyncAggBuffer(publish_k=3, policy=StalenessPolicy(exponent=0.0))
    for r, tr in enumerate(trees):
        buf.submit(r, tr, 1.0, client_version=buf.version)
    out = buf.publish()
    assert torch.equal(out["w"], buf.engine.aggregate([(1.0, t) for t in trees])["w"])
    buf.submit(0, trees[0], 1.0, client_version=buf.version)
    assert buf.discard() == 1 and buf.version == 1 and buf.publish() is None


# --- DP: the accountant ----------------------------------------------------------

@pytest.mark.parametrize("z,delta,q,steps", [(0.8, 1e-5, 1.0, 10), (1.2, 1e-6, 1.0, 3),
                                             (1.0, 1e-5, 0.1, 20), (2.0, 1e-5, 0.05, 7)])
def test_accountant_epsilon_matches_jax(z, delta, q, steps):
    pa = tpriv.DPAccountant(noise_multiplier=z, delta=delta, epsilon_budget=100.0,
                            sample_rate=q)
    ja = jpriv.DPAccountant(noise_multiplier=z, delta=delta, epsilon_budget=100.0,
                            sample_rate=q)
    for _ in range(steps):
        assert abs(pa.step() - ja.step()) <= 1e-12
    assert pa.steps == ja.steps == steps
    assert abs(pa.budget_frac() - ja.budget_frac()) <= 1e-12


def test_rdp_helpers_match_jax():
    for q in (1.0, 0.2):
        r_t = trdp.compute_rdp(q, 1.1, 4, trdp.DEFAULT_ORDERS)
        r_j = jrdp.compute_rdp(q, 1.1, 4, jrdp.DEFAULT_ORDERS)
        assert np.array_equal(r_t, r_j)
        assert trdp.get_privacy_spent(trdp.DEFAULT_ORDERS, r_t, 1e-6) == \
            jrdp.get_privacy_spent(jrdp.DEFAULT_ORDERS, r_j, 1e-6)


def test_accountant_budget_and_invalid_multiplier():
    acc = tpriv.DPAccountant(noise_multiplier=0.5, delta=1e-5, epsilon_budget=2.0)
    assert acc.budget_frac() == 0.0 and not acc.exhausted()
    while not acc.exhausted():
        acc.step()
    doc = acc.statusz()
    assert doc["epsilon_spent"] >= 2.0 and doc["budget_frac"] >= 1.0
    with pytest.raises(ValueError):
        tpriv.DPAccountant(noise_multiplier=0.0)


# --- DP: the fold ------------------------------------------------------------------

NOISE_D = 20_000


def _noise_stats(noise, sigma):
    d = noise.size
    assert abs(float(np.std(noise)) - sigma) <= 0.05 * sigma
    assert abs(float(np.mean(noise))) <= 4 * sigma / np.sqrt(d)


def test_dp_fold_noise_is_calibrated_on_the_mean_and_accounted():
    n, z, clip = 4, 0.8, 1.0
    buf = AsyncAggBuffer(publish_k=n, policy=StalenessPolicy(exponent=0.0))
    dp = tpriv.DPFold(noise_multiplier=z, l2_clip=clip, seed=3).attach(buf)
    for r in range(n):
        buf.submit(r, {"w": torch.zeros(NOISE_D)}, 1.0, client_version=buf.version)
    out = buf.publish()  # all-zero updates: the published model IS the noise
    _noise_stats(out["w"].numpy(), z * clip / n)
    assert dp.accountant.steps == 1 and dp.accountant.epsilon_spent > 0
    ref = jpriv.DPAccountant(noise_multiplier=z)
    assert abs(dp.accountant.epsilon_spent - ref.step()) <= 1e-12


def test_dp_fold_scales_the_sum_before_the_noise():
    """With the noise's std tiny the publish is the weighted mean."""
    rng = np.random.default_rng(4)
    trees = [{"w": torch.from_numpy(rng.normal(size=64).astype(np.float32))} for _ in range(3)]
    buf = AsyncAggBuffer(publish_k=3, policy=StalenessPolicy(exponent=0.0))
    tpriv.DPFold(noise_multiplier=1e-9, l2_clip=1.0).attach(buf)
    for r, (w, tr) in enumerate(zip((1.0, 2.0, 3.0), trees)):
        buf.submit(r, tr, w, client_version=0)
    out = buf.publish()["w"].double()
    mean = sum(w * t["w"].double() for w, t in zip((1.0, 2.0, 3.0), trees)) / 6.0
    assert float((out - mean).abs().max()) <= 1e-6


def test_dp_noise_follows_its_seed():
    def draw(seed):
        return tpriv.DPFold(seed=seed).noise_tree({"w": torch.zeros(1000)}, 2)["w"]

    assert torch.equal(draw(5), draw(5))
    assert not torch.equal(draw(5), draw(6))


def test_noise_tree_keeps_leaves_and_dtypes():
    tree = {"a": torch.zeros(100, 50), "b": torch.zeros(NOISE_D, dtype=torch.float64)}
    dp = tpriv.DPFold(noise_multiplier=1.5, l2_clip=2.0, seed=1)
    out = dp.noise_tree(tree, 3)
    assert list(out) == ["a", "b"] and out["a"].shape == (100, 50)
    assert out["b"].dtype == torch.float64
    _noise_stats(torch.cat([out["a"].reshape(-1), out["b"].float()]).numpy(), 1.5 * 2.0 / 3)
    assert dp.accountant.steps == 1


def test_secagg_plus_dp_noises_the_unmasked_mean():
    n = 3
    buf = AsyncAggBuffer(publish_k=n, policy=StalenessPolicy(exponent=0.0))
    dp = tpriv.DPFold(noise_multiplier=0.8, l2_clip=1.0, seed=7)
    co = tpriv.WindowCoordinator(buf, _ptemplate(), dp=dp, rng=np.random.default_rng(3))
    _, members = co.open_window(range(n))
    deltas = _deltas(n, 43)
    for r in range(n):
        co.submit(r, members[r].mask(_pflat(_to_port(deltas[r]))), client_version=0)
    out = _pflat(buf.publish())
    diff = out.astype(np.float64) - _honest([_jflat(d) for d in deltas], co.spec)
    assert not np.all(diff == 0) and float(np.abs(diff).max()) < 6 * 0.8 / n
    assert dp.accountant.steps == 1


# --- clipping ---------------------------------------------------------------------

def _ulps_apart(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.max(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))))


def test_clip_update_matches_jax():
    rng = np.random.default_rng(2)
    big = _jtree(rng, scale=10.0)
    got = tpriv.clip_update(_to_port(big), 1.0)
    want = jpriv.clip_update(big, 1.0)
    assert _ulps_apart(_pflat(got), _jflat(want)) <= 1
    assert float(np.linalg.norm(_pflat(got))) == pytest.approx(1.0, rel=1e-5)
    small = _to_port(_jtree(rng, scale=0.001))
    assert tpriv.clip_update(small, 1.0) is small


def test_clip_to_reference_is_the_input_within_the_ball():
    ref = _to_port(_jtree(np.random.default_rng(0)))
    near = {k: v + 0.001 for k, v in ref.items()}
    assert tpriv.clip_to_reference(near, ref, 1.0) is near


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_clip_to_reference_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ref, far = _jtree(rng, scale=10.0), _jtree(rng, scale=10.0)
    got = tpriv.clip_to_reference(_to_port(far), _to_port(ref), 1.0)
    want = jpriv.clip_to_reference(far, ref, 1.0)
    assert list(got) == PORT_ORDER and all(v.dtype == torch.float32 for v in got.values())
    assert _ulps_apart(_pflat(got), _jflat(want)) <= 1
    delta = _pflat(got).astype(np.float64) - _jflat(ref).astype(np.float64)
    assert float(np.linalg.norm(delta)) == pytest.approx(1.0, rel=1e-4)


# --- config and the comm-boundary gate ------------------------------------------------

def _args(**kw):
    return types.SimpleNamespace(**kw)


@pytest.mark.parametrize("raw", [None, "", "secagg", "dp", "secagg+dp", "SecAgg+DP", "dp,secagg"])
def test_privacy_config_parses_as_jax(raw):
    got = tpriv.privacy_from_args(_args(privacy=raw))
    want = jpriv.privacy_from_args(_args(privacy=raw))
    assert (got.secagg, got.dp, got.mode, got.enabled) == \
        (want.secagg, want.dp, want.mode, want.enabled)
    assert got.as_dict() == want.as_dict()
    assert (got.build_dp() is None) == (want.build_dp() is None)


def test_unknown_privacy_mode_rejected():
    for pkg in (tpriv, jpriv):
        with pytest.raises(ValueError, match="unknown mode"):
            pkg.privacy_from_args(_args(privacy="secagg+homomorphic"))


def test_privacy_knobs_flow_from_args_as_in_jax():
    kw = dict(privacy="secagg+dp", secagg_qbits=10, secagg_clip=2.0, secagg_threshold=3,
              secagg_window_deadline_s=4.0, secagg_window_max_extensions=2,
              dp_noise_multiplier=1.5, dp_l2_clip=0.5, dp_delta=1e-6, dp_epsilon_budget=3.0,
              dp_sample_rate=0.5, dp_seed=9)
    got, want = tpriv.privacy_from_args(_args(**kw)), jpriv.privacy_from_args(_args(**kw))
    assert got.__dict__ == want.__dict__
    assert got.quant_spec(8, 8).as_dict() == want.quant_spec(8, 8).as_dict()
    dp = got.build_dp()
    assert (dp.noise_multiplier, dp.l2_clip, dp.seed) == (1.5, 0.5, 9)
    assert dp.accountant.epsilon_budget == 3.0 and dp.accountant.sample_rate == 0.5


def test_outbound_delta_gates_raw_trees_under_secagg():
    tree = {"w": torch.ones(3)}
    assert tpriv.outbound_delta(tree, _args()) is tree
    assert tpriv.outbound_delta(tree, _args(privacy="dp")) is tree
    with pytest.raises(tpriv.PrivacyError):
        tpriv.outbound_delta(tree, _args(privacy="secagg"))
    with pytest.raises(tpriv.PrivacyError):
        tpriv.outbound_delta(tree, cfg=tpriv.privacy_from_args(_args(privacy="secagg+dp")))


def test_masked_uplink_payload_equals_jax():
    n = 3
    (_, jco), (_, pco) = _pair(n, 8)
    _, jm = jco.open_window(range(n))
    _, pm = pco.open_window(range(n))
    jt = _deltas(1, 2)[0]
    pp = tpriv.masked_uplink_payload(pm[0], _to_port(jt))
    jp = jpriv.masked_uplink_payload(jm[0], jt)
    assert tpriv.outbound_delta(pp, _args(privacy="secagg")) is pp
    assert sorted(pp) == sorted(jp) and pp[tpriv.SECAGG_PAYLOAD_KEY] is True
    assert (pp["rank"], pp["window_id"]) == (jp["rank"], jp["window_id"])
    assert np.array_equal(pp["masked"], jp["masked"])
    with pytest.raises(tpriv.PrivacyError):
        tpriv.submit_masked_payload(pco, {"w": torch.ones(3)})
