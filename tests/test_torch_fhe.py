"""The port's FHE (``fedml_tpu_torch/core/fhe``: the RLWE scheme, the
additive-mask scheme, the facade, the object-leaf fold and the hooks)
against the JAX package's, on the CPU.

On the CPU the port's ring products are the plain version (JAX's
``np.convolve``); the card's route, float64 negacyclic matrices, is run here
too at N=256 and held integer-equal to the plain one. Every encryption
generator is seeded on both sides (JAX's ``RLWEContext._rng`` is an
attribute: setting it edits nothing in JAX), so no test depends on OS
entropy, and no test makes a statistical check.

Tolerances:

- keys, ciphertexts, their sums and weighted sums, the object fold and the
  decryption: equal, integer for integer (the decryption float32 for
  float32);
- decryption against the fixed-point reference sum_i k_i rint(2^30 x_i) /
  2^46: within the worst-case RLWE noise bound
  sum_i k_i (2N + 1) B / 2^46 with B the largest error draw of the run, and
  half a float32 ulp;
- the additive-mask scheme: masks and decryptions equal to JAX's;
- FHE fronts against JAX's (LR, 2 clients, 2 rounds): test_loss within
  1e-4 relative round by round and the final model within 1e-4 of its scale,
  the f32 difference of the two packages' local rounds (the same bound the
  plain runs are held to) plus the RLWE noise (below 1e-6 here).

R10 and R11 (ROADMAP.md, Queue 3) are shown on both sides: JAX's sp front
publishes a loss of about 1e8 with ``additive_mask`` and JAX's byte
serializer refuses a ciphertext tree, where the port refuses both before
any round. R7 covers ``enable_fhe`` on ``backend: vmap``; R12 the
compositions that read or transform the ciphertexts before decryption.
"""

import types

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.core.aggregation.bucketed import BucketedAggregator as JBucketed
from fedml_tpu.core.alg_frame.context import Context as JContext
from fedml_tpu.core.fhe import fhe_agg as jfhe
from fedml_tpu.core.fhe import rlwe as jrlwe
from fedml_tpu_torch.core.aggregation.bucketed import BucketedAggregator
from fedml_tpu_torch.core.alg_frame.context import Context as TContext
from fedml_tpu_torch.core.fhe import fhe_agg as tfhe
from fedml_tpu_torch.core.fhe import rlwe as trlwe
from fedml_tpu_torch.models.convert import params_from_jax, params_to_jax
from tests.test_torch_security import reset_middleware

SMALL = dict(n=256, n_primes=4)
SP_LR = dict(model="lr", dataset="mnist", comm_round=2, epochs=1, client_num_in_total=2,
             client_num_per_round=2, frequency_of_the_test=1, enable_fhe=True,
             fhe_scheme="rlwe")


def _fhe_off():
    off = types.SimpleNamespace()
    jfhe.FedMLFHE.get_instance().init(off)
    tfhe.FedMLFHE.get_instance().init(off)
    for ctx in (JContext(), TContext()):
        ctx.store.pop("fhe_encrypted", None)


@pytest.fixture(autouse=True)
def fhe_off():
    reset_middleware()
    _fhe_off()
    yield
    reset_middleware()
    _fhe_off()


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seed(*ctxs, seed=11):
    for c in ctxs:
        c._rng = np.random.default_rng(seed)


def _contexts(seed=7, **params):
    p = params or SMALL
    return (jrlwe.RLWEContext(jrlwe.RLWEParams(**p), seed=seed),
            trlwe.RLWEContext(trlwe.RLWEParams(**p), seed=seed, device="cpu"),
            trlwe.RLWEContext(trlwe.RLWEParams(**p), seed=seed, device="cpu", route="matrix"))


def _values(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.5, s).astype(np.float32) for s in shapes]


def _assert_ct_equal(t, j):
    assert np.array_equal(t.c0.cpu().numpy(), j.c0) and np.array_equal(t.c1.cpu().numpy(), j.c1)
    assert t.scale == j.scale and tuple(t.shape) == tuple(j.shape) and t.size == j.size


# --- the scheme ------------------------------------------------------------------

@pytest.mark.parametrize("n", [256, 4096])
def test_keys_from_the_same_secret_equal_jax(n):
    j = jrlwe.RLWEScheme(b"shared secret", jrlwe.RLWEParams(n=n))
    t = trlwe.RLWEScheme(b"shared secret", trlwe.RLWEParams(n=n), device="cpu")
    assert t.ctx.params.primes == j.ctx.params.primes and t.ctx.params.q == j.ctx.params.q
    assert np.array_equal(t.ctx.s.numpy(), j.ctx.s)
    for tk, jk in zip(t.ctx.pk, j.ctx.pk):
        assert np.array_equal(tk.numpy(), jk)


def test_card_route_equals_the_plain_version():
    """The float64 negacyclic-matrix route (the card's) against the plain
    np.convolve route, run here on the CPU: keys, ciphertexts of several
    chunks and decryption residues integer-equal."""
    _, plain, matrix = _contexts()
    assert plain.route == "plain" and matrix.route == "matrix"
    assert torch.equal(plain.s, matrix.s)
    for a, b in zip(plain.pk, matrix.pk):
        assert torch.equal(a, b)
    xs = [torch.from_numpy(v) for v in _values(1, [(3, 300), (17,), (256,)])]
    _seed(plain, matrix)
    cp, cm = plain.encrypt_many(xs), matrix.encrypt_many(xs)
    assert [c.c0.shape[1] for c in cp] == [4, 1, 1]
    for a, b in zip(cp, cm):
        assert torch.equal(a.c0, b.c0) and torch.equal(a.c1, b.c1)
    assert torch.equal(plain.decrypt_residues(cp), matrix.decrypt_residues(cm))
    rng = np.random.default_rng(3)
    a, u = rng.integers(0, 1048573, 256), rng.integers(-1, 2, 256)
    mat = trlwe.negacyclic_matrix(torch.from_numpy(u))
    got = torch.matmul(mat, torch.from_numpy(a).double()).long() % 1048573
    assert np.array_equal(got.numpy(), trlwe.negacyclic_mul(u % 1048573, a, 1048573))


def test_card_crt_equals_the_host_crt():
    """garner_center (the card's CRT, run here on CPU tensors) against the
    host's Python-integer CRT: the same float64 for random residues and for
    the edges (0, +-1, +-q/2 and its neighbours, integers past 2^53 that
    float64 must round)."""
    P = trlwe.RLWEParams()
    rng = np.random.default_rng(0)
    res = np.stack([rng.integers(0, p, (20, 512)) for p in P.primes])
    half = P.q // 2
    ints = [0, 1, -1, half, -half, half - 1, half + 1, 2 ** 53 + 1, -(2 ** 53 + 1),
            2 ** 60 + 2 ** 7, 2 ** 79 + 2 ** 26 + 1, -(2 ** 79 + 2 ** 26), 3 * 2 ** 60 + 2 ** 8]
    edges = np.array([[x % P.q % p for x in ints] for p in P.primes], dtype=np.int64)
    for r in (res, edges):
        got = trlwe.garner_center(torch.from_numpy(r), P.primes, P.q)
        want = trlwe.crt_center(r, P.primes, P.q).astype(np.float64)
        assert got.dtype == torch.float64 and np.array_equal(got.numpy(), want)
    _, plain, matrix = _contexts()
    _seed(plain, matrix)
    x = torch.from_numpy(_values(8, [(700,)])[0])
    cp, cm = plain.encrypt(x), matrix.encrypt(x)
    res_m = matrix.decrypt_residues([cm])
    assert torch.equal(matrix.decode(res_m, [cm])[0], plain.decrypt(cp))
    assert torch.equal(matrix.decode(res_m, [cm], host_crt=True)[0], plain.decrypt(cp))


def test_ciphertexts_and_their_algebra_equal_jax():
    """With both encryption generators seeded alike: c0/c1, ``+``, ``* w``
    and decryption equal JAX's integer for integer."""
    j, t, _ = _contexts()
    x, y = _values(2, [(5, 70), (5, 70)])
    _seed(j, t)
    jx, jy = j.encrypt(x), j.encrypt(y)
    tx, ty = t.encrypt_many([torch.from_numpy(x), torch.from_numpy(y)])
    _assert_ct_equal(tx, jx)
    _assert_ct_equal(ty, jy)
    _assert_ct_equal(tx + ty, jx + jy)
    for w in (0.25, 0.6180339887, 1.0):
        _assert_ct_equal(tx * w, jx * w)
        _assert_ct_equal(w * tx + ty * (1 - w), w * jx + jy * (1 - w))
    got = t.decrypt(tx * 0.4 + ty * 0.6)
    want = j.decrypt(jx * 0.4 + jy * 0.6)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(t.decrypt(tx).numpy(), j.decrypt(jx))


def test_object_fold_equals_jax_weighted_average():
    """Ciphertext state dicts through the port's BucketedAggregator and JAX's
    engine: the weights normalised in f32 and passed as float(w), the folded
    ciphertexts equal, and so their decryption."""
    js = jrlwe.RLWEScheme(b"k", jrlwe.RLWEParams(**SMALL))
    ts = trlwe.RLWEScheme(b"k", trlwe.RLWEParams(**SMALL), device="cpu")
    _seed(js.ctx, ts.ctx)
    counts = [120.0, 37.0, 301.0]
    jt, tt = [], []
    for i in range(3):
        # keys in sorted order: JAX flattens a dict by sorted key, the port
        # encrypts in the state dict's order
        tree = dict(zip(("bias", "kernel"), _values(10 + i, [(5,), (6, 5)])))
        jt.append(js.encrypt(tree, nonce=i))
        tt.append(ts.encrypt({k: torch.from_numpy(v) for k, v in tree.items()}, nonce=i))
    jagg = JBucketed(16).aggregate(list(zip(counts, jt)))
    tagg = BucketedAggregator(16).aggregate(list(zip(counts, tt)))
    got, want = ts.decrypt_sum(tagg), js.decrypt_sum(jagg)
    for k in ("bias", "kernel"):
        _assert_ct_equal(tagg[k], jagg[k])
        assert np.array_equal(got[k].numpy(), want[k])


def test_decryption_within_the_noise_bound_of_the_fixed_point_sum():
    """decrypt(sum_i k_i ct_i) against sum_i k_i rint(2^30 x_i) / 2^46, within
    the stated worst-case noise bound: every error draw of the run below B,
    so |noise| <= sum_i k_i (2N + 1) B / 2^46."""
    _, t, _ = _contexts()
    xs = _values(4, [(1000,)] * 5)
    weights = np.asarray([3, 1, 4, 1, 5], np.float32)
    weights = weights / weights.sum()
    _seed(t, seed=5)
    cts = t.encrypt_many([torch.from_numpy(x) for x in xs])
    draws = np.random.default_rng(5)
    bound_b = 0
    for _ in range(sum(c.c0.shape[1] for c in cts)):
        draws.integers(-1, 2, 256)
        bound_b = max(bound_b, np.abs(np.rint(draws.normal(0, 3.2, 256))).max(),
                      np.abs(np.rint(draws.normal(0, 3.2, 256))).max())
    ks = [int(round(float(w) * 2 ** 16)) for w in weights]
    acc = cts[0] * float(weights[0])
    for w, c in zip(weights[1:], cts[1:]):
        acc = acc + c * float(w)
    got = t.decrypt(acc).numpy().astype(np.float64)
    fixed = sum(k * np.rint(x.astype(np.float64) * 2 ** 30) for k, x in zip(ks, xs)) / 2 ** 46
    # the key's e, drawn by the key generator (seed 7) after s and a
    keys = np.random.default_rng(7)
    keys.integers(-1, 2, 256)
    for p in t.params.primes:
        keys.integers(0, p, 256, dtype=np.int64)
    bound_b = max(bound_b, np.abs(np.rint(keys.normal(0, 3.2, 256))).max())
    noise = sum(ks) * (2 * 256 + 1) * bound_b / 2 ** 46
    ulp = np.spacing(np.abs(got).astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(got - fixed) <= noise + ulp), np.abs(got - fixed).max()
    plain = sum(float(w) * x.astype(np.float64) for w, x in zip(weights, xs))
    assert np.abs(got - plain).max() < 1e-3  # the 2^-16 weight rounding


def test_additive_mask_scheme_equals_jax():
    """The masks from the same (name, nonce) equal JAX's; the fixed-point
    payload under each mask equals JAX's (the port names a mask by the
    state-dict key, JAX by the pytree path string ``['w']``); a weighted sum
    of ciphertexts decrypts with explicit nonces and weights to JAX's
    answer."""
    jsch, tsch = jfhe.AdditiveMaskScheme(b"dealer"), tfhe.AdditiveMaskScheme(b"dealer")
    assert np.array_equal(tsch._mask("w", (4, 3), 9), jsch._mask("w", (4, 3), 9))
    a, b = _values(6, [(4, 3), (4, 3)])
    jc = [jsch.encrypt({"w": v}, n)["w"] for n, v in ((1, a), (2, b))]
    tc = [tsch.encrypt({"w": torch.from_numpy(v)}, n)["w"] for n, v in ((1, a), (2, b))]
    for n, t, j in zip((1, 2), tc, jc):
        assert t.dtype == torch.int64
        assert np.array_equal(t.numpy() - tsch._mask("w", (4, 3), n),
                              j - jsch._mask("['w']", (4, 3), n))
    weights = [2.0, 3.0]
    jsum = {"w": weights[0] * jc[0].astype(np.float64) + weights[1] * jc[1].astype(np.float64)}
    tsum = {"w": weights[0] * tc[0].double() + weights[1] * tc[1].double()}
    got = tsch.decrypt_sum(tsum, nonces=[1, 2], weights=weights)["w"]
    want = jsch.decrypt_sum(jsum, nonces=[1, 2], weights=weights)["w"]
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    np.testing.assert_allclose(got.numpy(), 2 * a + 3 * b, atol=5 * 2.0 ** -16)


def test_facade_and_init_configure_fhe():
    """``init`` configures the facade from the config (JAX's default scheme
    and warning when fhe_scheme is unset); an init without the flag turns
    it off; registered schemes build with the device."""
    args = fedml_tpu_torch.init(fedml_tpu_torch.default_config(
        "simulation", using_gpu=False, enable_fhe=True))
    fhe = tfhe.FedMLFHE.get_instance()
    assert fhe.is_fhe_enabled() and isinstance(fhe.scheme, trlwe.RLWEScheme)
    assert fhe.scheme.ctx.device.type == "cpu" and fhe.scheme.ctx.route == "plain"
    tree = {"a": torch.ones(3)}
    _seed(fhe.scheme.ctx)
    enc = fhe.fhe_enc("local", tree)
    assert isinstance(enc["a"], trlwe.Ciphertext) and fhe._nonce == 1
    assert torch.allclose(fhe.fhe_dec("global", enc)["a"], tree["a"], atol=1e-6)
    fedml_tpu_torch.init(fedml_tpu_torch.default_config("simulation", using_gpu=False))
    assert not fhe.is_fhe_enabled() and fhe.scheme is None
    seen = []
    tfhe.register_scheme("probe", lambda secret, device=None: seen.append(device) or "probe")
    try:
        fhe.init(types.SimpleNamespace(enable_fhe=True, fhe_scheme="probe"), device="cpu")
        assert fhe.scheme == "probe" and seen == ["cpu"]
    finally:
        tfhe._SCHEMES.pop("probe")
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            trlwe.RLWEContext(trlwe.RLWEParams(**SMALL), device="cuda")
        else:
            raise RuntimeError("CUDA present: nothing to refuse")


# --- the fronts --------------------------------------------------------------------

def _sp(pkg, kw, p0=None):
    """init, data, model and FedMLRunner; the encryption generator seeded."""
    if pkg is fedml_tpu:
        args = fedml_tpu.init(fedml_tpu.default_config("simulation", **kw))
        dataset = fedml_tpu.data.load(args)[0]
        model = fedml_tpu.model.create(args, dataset[-1])
        p0 = jax.device_get(model.params)
        dev = "cpu"
    else:
        args = fedml_tpu_torch.init(fedml_tpu_torch.default_config("simulation", using_gpu=False,
                                                                   **kw))
        dataset = fedml_tpu_torch.data.load(args)[0]
        model = fedml_tpu_torch.model.create(args, dataset[-1], device="cpu")
        model.module.load_state_dict(params_from_jax(p0))
        model.params = {k: v.clone() for k, v in model.module.state_dict().items()}
        dev = torch.device("cpu")
    facade = (jfhe if pkg is fedml_tpu else tfhe).FedMLFHE.get_instance()
    if facade.is_fhe_enabled():
        _seed(facade.scheme.ctx, seed=21)
    runner = pkg.FedMLRunner(args, dev, dataset, model)
    runner.run()
    api = runner.runner.fl_trainer
    w = api.model_trainer.get_model_params()
    w = jax.device_get(w) if pkg is fedml_tpu else params_to_jax(w)
    return p0, api.metrics_history, w


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


def _assert_run_close(hist, w, ref_hist, ref_w):
    assert [m["round"] for m in hist] == [m["round"] for m in ref_hist]
    for g, r in zip(hist, ref_hist):
        np.testing.assert_allclose(g["test_loss"], r["test_loss"], rtol=1e-4)
        assert abs(g["test_correct"] - r["test_correct"]) <= 2, (g, r)
    for k, r in _leaves(ref_w).items():
        g = _leaves(w)[k]
        assert np.abs(np.asarray(g) - r).max() <= 1e-4 * np.abs(r).max(), k


@pytest.mark.parametrize("opt", ["FedAvg", "HierarchicalFL"])
def test_rlwe_sp_run_tracks_jax(opt, one_torch_thread):
    """``enable_fhe`` with ``rlwe`` through init and FedMLRunner on the sp
    front, against JAX's run from the same init and generators; and the
    port's FHE run against its own plain run (the RLWE noise only)."""
    kw = dict(SP_LR, federated_optimizer=opt)
    p0, ref_hist, ref_w = _sp(fedml_tpu, kw)
    _, hist, w = _sp(fedml_tpu_torch, kw, p0)
    _assert_run_close(hist, w, ref_hist, ref_w)
    assert TContext().get("fhe_encrypted") is True
    _fhe_off()
    _, plain_hist, plain_w = _sp(fedml_tpu_torch, dict(kw, enable_fhe=False), p0)
    for k, r in _leaves(plain_w).items():
        assert np.abs(_leaves(w)[k] - r).max() <= 1e-4 * np.abs(r).max(), k


def test_rlwe_cross_silo_inmemory_tracks_jax(one_torch_thread):
    """A 2-silo INMEMORY federation with ``rlwe`` in both packages from the
    same init: the server decrypts each round's fold; the metrics and the
    global track JAX's."""
    from tests.test_torch_cross_silo import LR, Federation, _from_jax_params, _jax_p0, _record_evals
    from fedml_tpu.core.distributed.communication.inmemory.broker import InMemoryBroker as JB
    from fedml_tpu_torch.core.distributed.communication.inmemory.broker import InMemoryBroker as TB

    kw = dict(LR, enable_fhe=True, fhe_scheme="rlwe")
    p0 = _jax_p0(LR)
    out = {}
    for pkg, broker, prepare in ((fedml_tpu, JB, None), (fedml_tpu_torch, TB, _from_jax_params(p0))):
        run_id = f"fhe_cs_{pkg.__name__}"
        broker.reset(run_id)
        fed = Federation(pkg, run_id, kw, prepare=prepare)
        facade = (jfhe if pkg is fedml_tpu else tfhe).FedMLFHE.get_instance()
        _seed(facade.scheme.ctx, seed=31)
        hist = _record_evals(fed)
        fed.run()
        broker.reset(run_id)
        w = fed.server.aggregator.get_global_model_params()
        out[pkg] = (hist, jax.device_get(w) if pkg is fedml_tpu else params_to_jax(w))
    (ref_hist, ref_w), (hist, w) = out[fedml_tpu], out[fedml_tpu_torch]
    _assert_run_close(hist, w, ref_hist, ref_w)


@pytest.mark.parametrize("dp", [dict(dp_solution_type="ldp", epsilon=500.0),
                                dict(dp_solution_type="nbafl", epsilon=500.0),
                                dict(dp_solution_type="dp_clip", clipping_norm=5.0,
                                     noise_multiplier=0.05, train_data_num_in_total=1000),
                                dict(dp_solution_type="cdp", epsilon=500.0)])
def test_rlwe_composes_with_dp_as_in_jax(dp, one_torch_thread):
    """The DP frames JAX's sp front runs under FHE (local noise before the
    encryption, central noise after the decryption) run in the port; both
    packages still train (JAX's DP threshold, test_acc above 0.8)."""
    kw = dict(SP_LR, comm_round=1, enable_dp=True, **dp)
    p0, ref_hist, _ = _sp(fedml_tpu, kw)
    _, hist, _ = _sp(fedml_tpu_torch, kw, p0)
    assert ref_hist[-1]["test_acc"] > 0.8 and hist[-1]["test_acc"] > 0.8, (ref_hist, hist)


def test_r10_additive_mask_on_a_front_is_refused():
    """R10: JAX's sp front folds additive_mask's int64 ciphertexts as floats
    and unmasks one client: its loss is about 1e8. The port refuses the
    scheme on every front before any round."""
    jargs = fedml_tpu.default_config("simulation", **dict(SP_LR, comm_round=1,
                                                          fhe_scheme="additive_mask"))
    out = fedml_tpu.run_simulation(args=jargs)
    assert out["test_loss"] > 1e6, out
    args = fedml_tpu_torch.default_config("simulation", using_gpu=False,
                                          **dict(SP_LR, fhe_scheme="additive_mask"))
    with pytest.raises(ValueError, match="R10"):
        fedml_tpu_torch.run_simulation(args=args)
    for backend in ("INMEMORY",):
        with pytest.raises(ValueError, match="R10"):
            tfhe.refuse_fhe_front(args, "cross_silo", backend)


@pytest.mark.parametrize("backend", ["MQTT_S3", "MQTT_WEB3", "MQTT_THETASTORE", "TRPC", "GRPC",
                                     "MPI"])
def test_r11_byte_backends_refuse_ciphertexts(backend):
    """R11: JAX's byte serializer writes a ciphertext tree as object arrays
    and cannot read it back (its sends retry until the federation hangs);
    the port's cross-silo parties refuse FHE over a byte backend before any
    round."""
    from fedml_tpu.core.distributed.communication.serialization import (deserialize_pytree,
                                                                        serialize_pytree)

    sch = jrlwe.RLWEScheme(b"k", jrlwe.RLWEParams(**SMALL))
    tree = sch.encrypt({"w": np.ones(3, np.float32)}, nonce=1)
    with pytest.raises(ValueError, match="allow_pickle"):
        deserialize_pytree(serialize_pytree(tree))
    args = fedml_tpu_torch.default_config("cross_silo", using_gpu=False, enable_fhe=True,
                                          backend=backend, role="client", rank=1)
    with pytest.raises(ValueError, match="R11"):
        fedml_tpu_torch.FedMLRunner(args, torch.device("cpu"), None, None)
    tfhe.refuse_fhe_front(types.SimpleNamespace(enable_fhe=True), "cross_silo", "INMEMORY")


def test_r7_vmapped_front_refuses_fhe():
    """R7: the vmapped front runs no client hook, so JAX's never encrypts;
    the port refuses ``enable_fhe`` there before any round, on the barrier
    and the async driver alike."""
    for over in (dict(), dict(async_rounds=True)):
        args = fedml_tpu_torch.default_config("simulation", using_gpu=False, backend="vmap",
                                              **dict(SP_LR, **over))
        with pytest.raises(ValueError, match="R7"):
            fedml_tpu_torch.run_simulation(backend="vmap", args=args)


@pytest.mark.parametrize("over", [dict(federated_optimizer="FedOpt"),
                                  dict(federated_optimizer="FedNova"),
                                  dict(federated_optimizer="SCAFFOLD"),
                                  dict(federated_optimizer="FedDyn"),
                                  dict(federated_optimizer="Mime"),
                                  dict(federated_optimizer="Async_FedAvg"),
                                  dict(federated_optimizer="TA"),
                                  dict(federated_optimizer="split_nn"),
                                  dict(federated_optimizer="FedGKT"),
                                  dict(federated_optimizer="HierarchicalFL", group_comm_round=2),
                                  dict(enable_defense=True, defense_type="krum"),
                                  dict(enable_attack=True, attack_type="byzantine"),
                                  dict(enable_contribution=True, contribution_alg="loo"),
                                  dict(enable_dp=True, dp_solution_type="cdp", clipping_norm=5.0)])
def test_r12_compositions_that_read_ciphertexts_are_refused(over):
    """R12: each of these reads or transforms the uploads before the server
    decrypts (JAX fails on the ciphertexts, or sends SCAFFOLD's payload in
    the clear, or would value each subset's sum), or, as split NN and
    FedGKT, runs no client hook to encrypt; the port refuses them on the sp
    front before any round."""
    args = fedml_tpu_torch.default_config("simulation", using_gpu=False, **dict(SP_LR, **over))
    with pytest.raises(ValueError, match="R12"):
        tfhe.refuse_fhe_front(args, "sp")
    with pytest.raises(ValueError, match="R12"):
        fedml_tpu_torch.run_simulation(args=args)


@pytest.mark.parametrize("over", [dict(federated_optimizer="FedOpt"),
                                  dict(enable_defense=True, defense_type="krum",
                                       byzantine_client_num=0)])
def test_r12_jax_fails_on_the_ciphertexts(over):
    """R12's JAX side: FedOpt's server step and Krum's distances take the
    ciphertexts for arrays and raise."""
    args = fedml_tpu.default_config("simulation", **dict(SP_LR, comm_round=1, **over))
    with pytest.raises(TypeError, match="Ciphertext"):
        fedml_tpu.run_simulation(args=args)


def test_cross_silo_refuses_the_knobs_that_touch_uploads():
    for over in (dict(privacy="secagg"), dict(secure_aggregation="secagg"),
                 dict(comm_compressor="topk"), dict(async_rounds=True)):
        args = types.SimpleNamespace(enable_fhe=True, **over)
        with pytest.raises(ValueError, match="R12"):
            tfhe.refuse_fhe_front(args, "cross_silo", "INMEMORY")
