"""The port's round-barrier secure aggregation against the JAX package's, on
the CPU: ``core/mpc`` (the finite field, SecAgg, LightSecAgg) and the
``secure_aggregation: secagg | lightsecagg`` cross-silo fronts.

Tolerances:

- field arithmetic is exact, so the port is held bit-equal to JAX wherever
  JAX's int64 sums cannot wrap: JAX's own test sizes (``tests/test_mpc.py``,
  ``tests/test_cross_silo_secagg.py``), each case first checking that JAX's
  answer is the plain sum there, so that the comparison means something;
- at 8 and 16 members JAX's sums wrap (ROADMAP.md, Queue 3, R2:
  ``finite_field.py:92``, ``:101`` and ``:137`` add the Lagrange products,
  each below p^2 < 2^62, in one int64 matmul), so there the port is held to
  the plain int64 sum mod p, and JAX's answer is shown wrong;
- the state-dict helpers and the clients' quantization: bit-equal to JAX's
  pytree helpers on the same params, in JAX's flat order;
- the fronts against JAX (LR on the synthetic set, 2 clients, 2 rounds,
  the parties threads over INMEMORY): each round's test_loss within rtol
  1e-5 (the plain LR parity bound of tests/test_torch_cross_silo.py) and the
  final params within one quantum (2^-16) per coordinate: both packages
  train to within f32 noise, so an upload near a rounding edge of the grid
  lands one step apart, a step over the cohort's size in the mean; the
  float64 CNN federation of tests/test_torch_cross_silo.py the same (JAX
  quantizes and installs float32, so its second round trains float32
  params, the port's float64: the final params stay within one quantum);
- the port against itself: 8 clients, each round's global bit-equal to the
  plain quantized mean of the uploads its clients quantized before masking
  (the sum mod p, centred and dequantized in JAX's order).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu.core.mpc as jmpc
import fedml_tpu_torch
import fedml_tpu_torch.core.mpc as tmpc
from fedml_tpu.data import data_loader as jloader
from fedml_tpu.data.dataset import ArrayDataset as JArrayDataset
from fedml_tpu_torch.core import telemetry as tel
from fedml_tpu_torch.core.distributed.communication.inmemory.broker import InMemoryBroker
from fedml_tpu_torch.data import data_loader as tloader
from fedml_tpu_torch.data.dataset import ArrayDataset as TArrayDataset
from fedml_tpu_torch.models.convert import params_from_jax, params_to_jax, wire_vector

from tests.test_torch_cross_silo import (LR, Federation, _from_jax_params, _jax_p0, _leaves,
                                         _run_jax, _run_port, _small_cifar_f64)

P = jmpc.DEFAULT_PRIME
Q_BITS = 16
QUANTUM = 2.0 ** -Q_BITS
FRONTS = ("secagg", "lightsecagg")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Several parties train at once in each federation; under several test
    workers a pool of threads in each only spins against the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the finite field ---------------------------------------------------------


def test_lcc_polynomial_of_jax_test():
    """tests/test_mpc.py's polynomial: f(x) = 3 + 2x + x^2 through three
    points, encoded at three others and decoded back, numpy and tensor."""
    beta = np.array([1, 2, 3], dtype=np.int64)
    alpha = np.array([10, 20, 30], dtype=np.int64)
    vals = np.array([[(3 + 2 * b + b * b) % P] for b in beta], dtype=np.int64)
    enc = tmpc.lcc_encode(vals, alpha, beta, P)
    assert np.array_equal(enc, jmpc.lcc_encode(vals, alpha, beta, P))
    assert np.array_equal(enc.ravel(), [(3 + 2 * a + a * a) % P for a in alpha])
    assert np.array_equal(tmpc.lcc_decode(enc, alpha, beta, P), vals)
    assert np.array_equal(tmpc.lcc_encode(torch.from_numpy(vals), alpha, beta, P).numpy(), enc)


@pytest.mark.parametrize("n,u,t,d", [(4, 3, 1, 10), (6, 4, 2, 17), (5, 5, 2, 8)])
def test_lcc_matches_jax_at_its_lightsecagg_sizes(n, u, t, d):
    """The LightSecAgg geometry of tests/test_mpc.py (beta 1..N, alpha
    N+1..N+U) on a random payload: encode and decode bit-equal to JAX's, the
    round trip exact, numpy and tensor alike."""
    cfg = tmpc.LightSecAggConfig(num_clients=n, target_active=u, privacy_guarantee=t)
    payload = np.random.default_rng(d).integers(0, P, size=(u, d), dtype=np.int64)
    enc = tmpc.lcc_encode(payload, cfg.beta, cfg.alpha, P)
    assert np.array_equal(enc, jmpc.lcc_encode(payload, cfg.beta, cfg.alpha, P))
    assert np.array_equal(tmpc.lcc_encode(torch.from_numpy(payload), cfg.beta, cfg.alpha, P).numpy(),
                          enc)
    ids = np.arange(u)
    dec = tmpc.lcc_decode(enc[ids], cfg.beta[ids], cfg.alpha, P)
    assert np.array_equal(dec, jmpc.lcc_decode(enc[ids], cfg.beta[ids], cfg.alpha, P))
    assert np.array_equal(dec, payload)


def test_lcc_round_trip_beyond_the_wrap():
    """16 rows (LightSecAgg's U at 16 silos): the port's round trip is exact
    where JAX's one-matmul sum wraps (R2)."""
    cfg = tmpc.LightSecAggConfig(num_clients=16, target_active=16, privacy_guarantee=8)
    payload = np.random.default_rng(0).integers(0, P, size=(16, 64), dtype=np.int64)
    enc = tmpc.lcc_encode(payload, cfg.beta, cfg.alpha, P)
    assert np.array_equal(tmpc.lcc_decode(enc, cfg.beta, cfg.alpha, P), payload)
    jenc = jmpc.lcc_encode(payload, cfg.beta, cfg.alpha, P)
    assert not np.array_equal(jmpc.lcc_decode(jenc, cfg.beta, cfg.alpha, P), payload)


def test_additive_shares_match_jax():
    """tests/test_mpc.py's size: the same draws, rows summing to 0 mod p."""
    sh = tmpc.additive_shares(10, 4, P, np.random.default_rng(1))
    assert np.array_equal(sh, jmpc.additive_shares(10, 4, P, np.random.default_rng(1)))
    assert np.all(sh.sum(axis=0) % P == 0)


def test_quantizers_match_jax_on_numpy_and_tensors():
    """tests/test_mpc.py's values plus halves (round half to even) and a
    spread: quantize and dequantize bit-equal to JAX's, on numpy and on a
    tensor."""
    x = np.concatenate([np.array([-1.5, 0.0, 0.25, 3.75, -0.125], np.float32),
                        np.array([0.5, 1.5, 2.5, -0.5, -2.5], np.float32) / 2 ** Q_BITS,
                        np.random.default_rng(0).normal(size=1000).astype(np.float32)])
    q = jmpc.quantize(x, Q_BITS, P)
    assert np.array_equal(tmpc.quantize(x, Q_BITS, P), q)
    assert np.array_equal(tmpc.quantize(torch.from_numpy(x), Q_BITS, P).numpy(), q)
    back = jmpc.dequantize(q, Q_BITS, P)
    assert np.array_equal(tmpc.dequantize(q, Q_BITS, P), back)
    assert np.array_equal(tmpc.dequantize(torch.from_numpy(q), Q_BITS, P).numpy(), back)


@pytest.mark.parametrize("model", ["cnn_cifar", "resnet20"])
def test_state_dict_finite_helpers_match_jax(model):
    """A JAX model's params converted to the port's state dict: the flat
    int64 vector, the sizes, the way back and the clients' f32-first
    quantization (on a float64 copy) bit-equal to JAX's pytree helpers."""
    args = fedml_tpu.default_config("cross_silo", dataset="cifar10", model=model, random_seed=0)
    p0 = jax.device_get(fedml_tpu.model.create(args, 10).params)
    state = params_from_jax(p0)
    jflat, treedef, shapes = jmpc.flatten_finite(jmpc.tree_to_finite(p0, Q_BITS, P))
    flat = tmpc.flatten_finite(tmpc.tree_to_finite(state, Q_BITS, P))
    assert flat.dtype == torch.int64 and np.array_equal(flat.numpy(), jflat)
    assert tmpc.tree_dimensions(state) == jmpc.tree_dimensions(p0)
    back = tmpc.tree_from_finite(tmpc.unflatten_finite(flat, state), Q_BITS, P)
    jback = params_from_jax(jmpc.tree_from_finite(jmpc.unflatten_finite(jflat, treedef, shapes),
                                                  Q_BITS, P))
    assert list(back) == list(state)
    assert all(back[k].dtype == torch.float32 and torch.equal(back[k], jback[k]) for k in back)
    # a float64 model: each leaf is cast to float32 before it is quantized
    noise = np.random.default_rng(1)
    p64 = jax.tree.map(lambda a: np.asarray(a, np.float64) + 1e-9 * noise.normal(size=a.shape), p0)
    want, _, _ = jmpc.flatten_finite(
        jax.tree.map(lambda a: jmpc.quantize(np.asarray(a, np.float32), Q_BITS, P), p64))
    got = tmpc.quantize(wire_vector(params_from_jax(p64), torch.float32), Q_BITS, P)
    assert np.array_equal(got.numpy(), want)


# --- the protocols ------------------------------------------------------------


def _plain_sum(xs, keep):
    total = np.zeros_like(next(iter(xs.values())))
    for i in keep:
        total = (total + xs[i]) % P
    return total


@pytest.mark.parametrize("n,threshold,dropouts,d", [(4, 2, (), 12), (5, 2, (1, 3), 8)])
def test_secagg_round_matches_jax(n, threshold, dropouts, d):
    """tests/test_mpc.py's two rounds: the same seeds give the same answer,
    which is the plain sum of the survivors."""
    rng = np.random.default_rng(n)
    xs = {i: rng.integers(0, 10_000, size=d).astype(np.int64) for i in range(n)}
    want = _plain_sum(xs, [i for i in xs if i not in dropouts])
    jout = jmpc.run_secagg_round(jmpc.SecAggConfig(n, threshold), xs, dropouts=dropouts, seed=9)
    assert np.array_equal(jout, want)
    out = tmpc.run_secagg_round(tmpc.SecAggConfig(n, threshold), xs, dropouts=dropouts, seed=9)
    assert np.array_equal(out, jout)


def _lsa_round(mpc, n, u, t, d, xs, device=None):
    """tests/test_mpc.py's LightSecAgg round; with ``device`` the port
    encodes there and decodes the aggregates as tensors."""
    cfg = mpc.LightSecAggConfig(num_clients=n, target_active=u, privacy_guarantee=t)
    kw = {} if device is None else {"device": device}
    states = {i: mpc.encode_mask(cfg, d, np.random.default_rng(100 + i), **kw) for i in range(n)}
    mpc.exchange_shares(states)
    active = list(range(u))
    masked_sum = np.zeros(d, dtype=np.int64)
    for i in active:
        masked_sum = np.mod(masked_sum + mpc.mask_vector(cfg, xs[i], states[i]), P)
    agg = {i: mpc.aggregate_encoded_mask(cfg, states[i], active) for i in active}
    if device is not None:
        masked_sum = torch.from_numpy(masked_sum).to(device)
        agg = {i: torch.from_numpy(a).to(device) for i, a in agg.items()}
    out = mpc.unmask_aggregate(cfg, masked_sum, agg)
    return out.cpu().numpy() if device is not None else out


@pytest.mark.parametrize("n,u,t,d", [(4, 3, 1, 10), (6, 4, 2, 17), (5, 5, 2, 8)])
def test_lightsecagg_round_matches_jax(n, u, t, d):
    rng = np.random.default_rng(3)
    xs = {i: rng.integers(0, 1000, size=d).astype(np.int64) for i in range(n)}
    jout = _lsa_round(jmpc, n, u, t, d, xs)
    assert np.array_equal(jout, _plain_sum(xs, range(u)))
    assert np.array_equal(_lsa_round(tmpc, n, u, t, d, xs), jout)
    assert np.array_equal(_lsa_round(tmpc, n, u, t, d, xs, device="cpu"), jout)


@pytest.mark.parametrize("case", ["secagg-8", "secagg-16", "secagg-16-dropouts",
                                  "lsa-16-16-8", "lsa-16-8-4", "lsa-8-8-4"])
def test_beyond_the_wrap_the_port_equals_the_plain_sum(case):
    """Not held to JAX here (R2): at 8 and 16 members JAX's Lagrange sums
    wrap int64 (``finite_field.py:92/101/137``), and its answer is wrong in
    every coordinate; the port reduces each product mod p and equals the
    plain int64 sum mod p. SecAgg at the fronts' default threshold n//2,
    LightSecAgg at the front's default (N, N, N//2) and at U < N."""
    kind, *sizes = case.split("-")
    rng = np.random.default_rng(7)
    d = 24
    if kind == "secagg":
        n = int(sizes[0])
        dropouts = (1, 3) if len(sizes) > 1 else ()
        xs = {i: rng.integers(0, 2 ** 20, size=d).astype(np.int64) for i in range(n)}
        want = _plain_sum(xs, [i for i in xs if i not in dropouts])
        out = tmpc.run_secagg_round(tmpc.SecAggConfig(n, n // 2), xs, dropouts=dropouts, seed=9)
        jout = jmpc.run_secagg_round(jmpc.SecAggConfig(n, n // 2), xs, dropouts=dropouts, seed=9)
    else:
        n, u, t = map(int, sizes)
        xs = {i: rng.integers(0, 2 ** 20, size=d).astype(np.int64) for i in range(n)}
        want = _plain_sum(xs, range(u))
        out = _lsa_round(tmpc, n, u, t, d, xs)
        assert np.array_equal(_lsa_round(tmpc, n, u, t, d, xs, device="cpu"), want)
        jout = _lsa_round(jmpc, n, u, t, d, xs)
    assert np.array_equal(out, want)
    assert not np.any(jout == want)


def test_strip_masks_on_a_tensor_equals_numpy():
    """The fronts' server strips the host-drawn masks from a sum held on its
    device: the same answer as the numpy path, with a dropout."""
    cfg = tmpc.SecAggConfig(5, 2)
    rng = np.random.default_rng(0)
    clients = {i: tmpc.SecAggClient(i, cfg, np.random.default_rng(10 + i)) for i in range(5)}
    server = tmpc.SecAggServer(cfg)
    for i, c in clients.items():
        server.register_key(i, c.advertise_keys())
    for c in clients.values():
        c.peer_public = dict(server.public_keys)
    for i, c in clients.items():
        for j, sh in c.share_keys().items():
            clients[j].receive_share(i, sh["sk"], sh["b"])
    xs = {i: rng.integers(0, 2 ** 20, size=16).astype(np.int64) for i in range(5)}
    for i, c in clients.items():
        server.submit(i, c.masked_input(xs[i]))
    del server.masked[2]
    reveals = {i: clients[i].reveal([0, 1, 3, 4], [2]) for i in (0, 1, 3, 4)}
    total = np.zeros(16, np.int64)
    for i in sorted(server.masked):
        total = (total + server.masked[i]) % P
    out = server.strip_masks(torch.from_numpy(total), reveals)
    assert isinstance(out, torch.Tensor)
    assert np.array_equal(out.numpy(), server.unmask(reveals))
    assert np.array_equal(out.numpy(), _plain_sum(xs, (0, 1, 3, 4)))


# --- the fronts ---------------------------------------------------------------


def _secure(kw, secure):
    return dict(kw, secure_aggregation=secure, quantize_bits=Q_BITS)


def _max_abs(got, ref):
    g, r = _leaves(got), _leaves(ref)
    assert sorted(g) == sorted(r)
    return max(float(np.abs(np.asarray(g[k], np.float64) - np.asarray(r[k], np.float64)).max())
               for k in r)


@pytest.mark.parametrize("secure", FRONTS)
def test_secure_front_tracks_jax_round_by_round(secure):
    """tests/test_cross_silo_secagg.py's federation in both packages, the
    port from the JAX server's initial params."""
    kw = _secure(LR, secure)
    p0 = _jax_p0(kw)
    _, ref_hist, ref_w = _run_jax(f"tsa_jax_lr_{secure}", kw)
    fed, hist, w = _run_port(f"tsa_port_lr_{secure}", kw, prepare=_from_jax_params(p0))
    assert [m["round"] for m in hist] == [m["round"] for m in ref_hist] == [0, 1]
    for g, r in zip(hist, ref_hist):
        assert g["test_total"] == r["test_total"]
        np.testing.assert_allclose(g["test_loss"], r["test_loss"], rtol=1e-5)
    assert fed.server.final_metrics == hist[-1]
    assert _max_abs(params_to_jax(w), ref_w) <= QUANTUM
    for k, v in w.items():
        assert v.device.type == "cpu" and v.dtype == torch.float32, k


@pytest.mark.parametrize("secure", FRONTS)
def test_secure_cnn_federation_in_float64_ends_within_a_quantum_of_jax(secure):
    kw = _secure(dict(LR, dataset="cifar10", model="cnn_cifar", partition_method="hetero",
                      partition_alpha=0.5, learning_rate=0.01, momentum=0.9, weight_decay=5e-4),
                 secure)
    p0 = _jax_p0(kw)

    def jprep(role, rank, args, dataset, model):
        model.params = jax.tree.map(lambda leaf: jnp.asarray(leaf, jnp.float64), p0)
        return dataset, model

    jload = _small_cifar_f64(jloader.load, JArrayDataset, fedml_tpu.default_config("cross_silo", **kw))
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)  # global: the parties run on their own threads
    try:
        _, ref_hist, ref_w = _run_jax(f"tsa_jax_cnn_{secure}", kw, prepare=jprep, load=jload)
    finally:
        jax.config.update("jax_enable_x64", prev)
    tload = _small_cifar_f64(tloader.load, TArrayDataset,
                             fedml_tpu_torch.default_config("cross_silo", **kw))
    _, hist, w = _run_port(f"tsa_port_cnn_{secure}", kw, prepare=_from_jax_params(p0, torch.float64),
                           load=tload)
    assert all(v.dtype == torch.float64 for v in w.values())
    assert [m["round"] for m in hist] == [m["round"] for m in ref_hist] == [0, 1]
    moved = _max_abs(params_to_jax(w), p0)
    assert moved > 100 * QUANTUM
    assert _max_abs(params_to_jax(w), ref_w) <= QUANTUM


def _plain_quantized_mean(uploads):
    """The mean of the pre-mask uploads, in JAX's order on the host: the
    int64 sum mod p, centred, float64 over 2^q, float32, over n in float32."""
    total = np.zeros_like(uploads[0])
    for u in uploads:
        total = (total + u) % P
    centred = np.where(total > (P - 1) // 2, total - P, total)
    mean = (centred.astype(np.float64) / 2 ** Q_BITS).astype(np.float32)
    return mean / np.float32(len(uploads))


@pytest.mark.parametrize("secure", FRONTS)
def test_eight_silos_equal_the_plain_quantized_mean(secure):
    """8 LR silos, 2 rounds, where JAX's sums would wrap: each round's
    global bit-equal to the plain mean of what its clients quantized before
    masking; the broadcast global untouched by the clients that train from
    it (INMEMORY hands it over by reference); one span of each kind per
    party and round."""
    run_id = f"tsa_eight_{secure}"
    kw = _secure(dict(LR, client_num_in_total=8, client_num_per_round=8), secure)
    InMemoryBroker.reset(run_id)
    fed = Federation(fedml_tpu_torch, run_id, kw)
    uploads, globals_ = {}, []
    lock = threading.Lock()
    for rank in range(1, 9):
        cm = fed.runners[rank].runner.client_manager

        def recorded(weights, _q=cm.quantize, _rank=rank):
            out = _q(weights)
            with lock:
                uploads.setdefault(int(fed.runners[_rank].runner.client_manager.args.round_idx),
                                   {})[_rank] = out.copy()
            return out
        cm.quantize = recorded
    agg = fed.server.aggregator
    reconstruct = agg.aggregate_model_reconstruction

    def recorded_global():
        out = reconstruct()
        globals_.append((out, {k: v.clone() for k, v in out.items()}))
        return out
    agg.aggregate_model_reconstruction = recorded_global
    since = max((r["seq"] for r in tel.snapshot()["spans"]), default=0)
    fed.run()
    InMemoryBroker.reset(run_id)
    assert sorted(uploads) == [0, 1] and all(sorted(u) == list(range(1, 9)) for u in uploads.values())
    assert len(globals_) == 2
    for rnd, (out, frozen) in enumerate(globals_):
        want = _plain_quantized_mean([uploads[rnd][r] for r in range(1, 9)])
        assert np.array_equal(wire_vector(frozen).numpy(), want)
        assert all(torch.equal(out[k], frozen[k]) for k in frozen)
    assert any(not torch.equal(globals_[0][1][k], globals_[1][1][k]) for k in globals_[0][1])
    prefix = "sa" if secure == "secagg" else "lsa"
    steps = ("quantize", "mask", "server_sum", "dequantize") + \
        (("unmask",) if secure == "secagg" else ("encode", "decode"))
    counts = {}
    for r in tel.snapshot()["spans"]:
        if r["seq"] > since and (r["name"] == "client.train" or r["name"].startswith(prefix + ".")):
            counts[r["name"]] = counts.get(r["name"], 0) + 1
    per_client = {"client.train", f"{prefix}.quantize", f"{prefix}.mask", f"{prefix}.encode",
                  f"{prefix}.server_sum"}
    assert counts == {name: 2 * 8 if name in per_client else 2
                      for name in ["client.train"] + [f"{prefix}.{s}" for s in steps]}


@pytest.mark.parametrize("secure", ["secagg", "lsa"])
def test_secure_front_asked_for_cuda_without_a_card_raises(secure, monkeypatch):
    """No fallback: a secure party given a CUDA device where there is no
    card refuses to build."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for role in ("server", "client"):
        args = fedml_tpu_torch.default_config(
            "cross_silo", **_secure(dict(LR, run_id=f"tsa_cuda_{secure}_{role}", backend="INMEMORY",
                                         rank=0 if role == "server" else 1, role=role,
                                         using_gpu=False), secure))
        dataset, output_dim = fedml_tpu_torch.data.load(args)
        model = fedml_tpu_torch.model.create(args, output_dim, device="cpu")
        with pytest.raises(RuntimeError, match="CUDA"):
            fedml_tpu_torch.FedMLRunner(args, torch.device("cuda"), dataset, model)
        InMemoryBroker.reset(args.run_id)
