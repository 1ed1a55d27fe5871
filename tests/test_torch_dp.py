"""The port's DP middleware (``fedml_tpu_torch/core/dp``: the mechanisms, the
cdp, ldp, nbafl and dp_clip frames, the facade and its accountant) against
the JAX package's, on the CPU.

Tolerances:

- sigmas, scales, DPClip's qW, NbAFL's m, sigma_u and sigma_d: equal (the
  same host float math);
- clips (the global-norm clip, the frames' per-client clip, DPClip's delta
  clip, NbAFL's coordinate clip): within 1e-6 of their scale (the norm
  summed in other orders);
- the accountant's epsilon after the facades' own steps: within 1e-12 of
  JAX's;
- the noise (no PRNG matches across frameworks): the std of the draws within
  4 standard errors (4 / sqrt(2 n)) of the sigma each frame reports, and
  their mean within 4 sigma / sqrt(n), as tests/test_privacy.py tests DP
  noise; the same bounds hold for JAX's draws;
- end to end: JAX's own thresholds (``tests/test_dp.py``): test_acc above
  0.8 after 2 rounds.

R7 (ROADMAP.md, Queue 3) is shown on both sides: JAX's vmapped front skips
the client hooks, so its ldp model is the un-noised one while its epsilon
grows; the port refuses the knob.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.arguments import default_config as jdefault_config
from fedml_tpu.core.dp import frames as jframes
from fedml_tpu.core.dp import mechanisms as jmech
from fedml_tpu.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy as JDP
from fedml_tpu.utils.pytree import tree_clip_by_global_norm as jclip
from fedml_tpu_torch.core.dp import frames as tframes
from fedml_tpu_torch.core.dp import mechanisms as tmech
from fedml_tpu_torch.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy as TDP
from fedml_tpu_torch.models.convert import params_from_jax
from fedml_tpu_torch.utils.pytree import tree_clip_by_global_norm as tclip
from tests.test_torch_security import assert_tree_close, middleware_off, one_torch_thread  # noqa: F401

SOLUTIONS = ("cdp", "ldp", "nbafl", "dp_clip")


def _args(**kw):
    base = dict(enable_dp=True, dp_solution_type="cdp", mechanism_type="gaussian", epsilon=1.0,
                delta=1e-5, sensitivity=1.0, random_seed=0, comm_round=10,
                client_num_per_round=2, client_num_in_total=4)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _tree(seed=0, big=False):
    """A flax tree (Dense [in, out] and Conv HWIO kernels) of numpy f32."""
    rng = np.random.default_rng(seed)
    dense = (300, 100) if big else (6, 5)
    return {"Dense_0": {"kernel": rng.normal(size=dense).astype(np.float32),
                        "bias": rng.normal(size=dense[1:]).astype(np.float32)},
            "Conv_0": {"kernel": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
                       "bias": rng.normal(size=(4,)).astype(np.float32)}}


def _flat(state):
    return torch.cat([v.reshape(-1) for v in state.values()]).double().numpy()


def _jflat(tree):
    return np.concatenate([np.ravel(np.asarray(v, np.float64)) for v in jax.tree.leaves(tree)])


def assert_draws(noise, sigma):
    n = noise.size
    assert abs(noise.std() / sigma - 1) <= 4 / math.sqrt(2 * n), (noise.std(), sigma)
    assert abs(noise.mean()) <= 4 * sigma / math.sqrt(n), noise.mean()


def test_frame_factory_dispatch():
    for sol, cls in (("cdp", "GlobalDP"), ("ldp", "LocalDP"), ("nbafl", "NbAFLDP"),
                     ("dp_clip", "DPClip"), ("dpclip", "DPClip")):
        t = tframes.create_dp_frame(_args(dp_solution_type=sol, clipping_norm=1.0))
        j = jframes.create_dp_frame(_args(dp_solution_type=sol, clipping_norm=1.0))
        assert type(t).__name__ == type(j).__name__ == cls
    with pytest.raises(ValueError):
        tframes.create_dp_frame(_args(dp_solution_type="bogus"))
    with pytest.raises(ValueError, match="unknown DP mechanism"):
        tmech.create_mechanism("bogus", epsilon=1.0)


@pytest.mark.parametrize("eps,delta,sens", [(1.0, 1e-5, 1.0), (0.3, 1e-3, 2.5), (8.0, 1e-6, 0.1)])
def test_mechanism_sigmas_are_jax_sigmas(eps, delta, sens):
    assert tmech.Gaussian(epsilon=eps, delta=delta, sensitivity=sens).sigma == \
        jmech.Gaussian(epsilon=eps, delta=delta, sensitivity=sens).sigma
    assert tmech.Laplace(epsilon=eps, sensitivity=sens).scale == \
        jmech.Laplace(epsilon=eps, sensitivity=sens).scale
    with pytest.raises(ValueError):
        tmech.Gaussian(epsilon=eps, delta=0.0)


def test_round_statistics_are_jax_statistics():
    """DPClip's qW and sigma, NbAFL's m, sigma_u and sigma_d from the same
    round lists, sample counts and the vmapped front's fractions alike."""
    for lst_w in ([20.0, 5.0], [0.625, 0.375]):
        for kw in (dict(comm_round=10), dict(comm_round=2), dict(comm_round=40, nbafl_C=0.5)):
            a = _args(dp_solution_type="nbafl", **kw)
            t, j = tframes.NbAFLDP(a), jframes.NbAFLDP(a)
            t.set_params_for_dp([(n, None) for n in lst_w])
            j.set_params_for_dp([(n, None) for n in lst_w])
            assert t.m == j.m and t.get_rdp_scale() == j.get_rdp_scale()
            want = 0.0 if a.comm_round <= math.sqrt(4) * 2 else \
                2.0 * j.small_c * j.big_c * math.sqrt(a.comm_round ** 2 - 4 * 4) / (j.m * 4 * 1.0)
            assert t.sigma_d() == want
        a = _args(dp_solution_type="dp_clip", clipping_norm=2.0, noise_multiplier=0.7,
                  train_data_num_in_total=1000)
        t, j = tframes.DPClip(a), jframes.DPClip(a)
        assert t._qw() == j._qw() == 500.0
        t.set_params_for_dp([(n, None) for n in lst_w])
        j.set_params_for_dp([(n, None) for n in lst_w])
        assert t._qw() == j._qw() and t.sigma() == 2.0 * 0.7 / j._qw()
    assert tframes.NbAFLDP(_args()).m == 1


@pytest.mark.parametrize("max_norm", [0.5, 3.0, 1e3])
def test_global_norm_clip_is_jax_clip(max_norm):
    tree = _tree(1)
    assert_tree_close(jclip(jax.tree.map(jnp.asarray, tree), max_norm),
                      tclip(params_from_jax(tree), max_norm), tol=1e-6)
    lst = [(3.0, _tree(2)), (5.0, _tree(3))]
    a = _args(max_grad_norm=max_norm)
    jl = jframes.GlobalDP(a).global_clip([(n, jax.tree.map(jnp.asarray, t)) for n, t in lst])
    tl = tframes.GlobalDP(a).global_clip([(n, params_from_jax(t)) for n, t in lst])
    for (_, jt), (_, tt) in zip(jl, tl):
        assert_tree_close(jt, tt, tol=1e-6)


def test_dp_clip_delta_clip_is_jax_clip():
    a = _args(dp_solution_type="dp_clip", clipping_norm=1.0, noise_multiplier=1.0,
              train_data_num_in_total=100)
    local, glob = _tree(4), _tree(5)
    jo = jframes.DPClip(a).add_local_noise(jax.tree.map(jnp.asarray, local), jax.random.PRNGKey(0),
                                           {"global_model_params": jax.tree.map(jnp.asarray, glob)})
    to = tframes.DPClip(a).add_local_noise(params_from_jax(local), None,
                                           {"global_model_params": params_from_jax(glob)})
    assert_tree_close(jo, to, tol=1e-6)
    same = params_from_jax(local)
    assert tframes.DPClip(a).add_local_noise(same, None, None) is same


@pytest.mark.parametrize("mechanism", ["gaussian", "laplace"])
def test_mechanism_draws(mechanism):
    """Each leaf noised with its mechanism's scale (std sigma, or scale *
    sqrt(2) for Laplace), f32 draws cast to the leaf's dtype, drawn in wire
    order whatever the state dict's key order."""
    mech = tmech.create_mechanism(mechanism, epsilon=2.0, delta=1e-5, sensitivity=0.01)
    std = mech.sigma if mechanism == "gaussian" else mech.scale * math.sqrt(2)
    tree = params_from_jax(_tree(6, big=True))
    out = mech.add_noise(tree, torch.Generator().manual_seed(0))
    assert_draws(_flat(out) - _flat(tree), std)
    jm = jmech.create_mechanism(mechanism, epsilon=2.0, delta=1e-5, sensitivity=0.01)
    jt = jax.tree.map(jnp.asarray, _tree(6, big=True))
    assert_draws(_jflat(jm.add_noise(jt, jax.random.PRNGKey(0))) - _jflat(jt), std)
    rev = {k: tree[k] for k in reversed(list(tree))}
    out_rev = mech.add_noise(rev, torch.Generator().manual_seed(0))
    for k in tree:
        assert torch.equal(out[k], out_rev[k])
    half = {k: v.to(torch.bfloat16) for k, v in tree.items()}
    assert all(v.dtype == torch.bfloat16 for v in mech.add_noise(half, torch.Generator()).values())


@pytest.mark.parametrize("solution", SOLUTIONS)
def test_facade_noise_and_epsilon_follow_jax(solution):
    """Two rounds of each solution through both facades: the same clips and
    round statistics, draws of each frame's own sigma, and the same epsilon
    from the one accountant stepped once a round."""
    a = _args(dp_solution_type=solution, clipping_norm=5.0, noise_multiplier=0.3,
              epsilon=2.0, comm_round=40, train_data_num_in_total=1000)
    j, t = JDP.get_instance(), TDP.get_instance()
    j.init(a)
    t.init(a)
    assert (t.is_local_dp_enabled(), t.is_global_dp_enabled(), t.is_clipping()) == \
        (j.is_local_dp_enabled(), j.is_global_dp_enabled(), j.is_clipping())
    assert t.sample_rate == j.sample_rate == 0.5
    glob = _tree(7, big=True)
    for r in range(2):
        lst = [(300.0, _tree(10 + r, big=True)), (200.0, _tree(20 + r, big=True))]
        if t.is_local_dp_enabled():
            extra = {"global_model_params": params_from_jax(glob), "local_sample_num": 300}
            sent = params_from_jax(lst[0][1])
            out = t.add_local_noise(sent, extra)
            if solution == "ldp":
                base = tclip(sent, 5.0)
                sigma = t.frame.ldp.sigma
            elif solution == "nbafl":
                base = {k: v / torch.clamp(v.abs() / t.frame.big_c, min=1.0) for k, v in sent.items()}
                sigma = t.frame._sigma_u(300)
            else:
                base, sigma = out, None  # dp_clip clips on the client and adds no noise
            if sigma:
                assert_draws(_flat(out) - _flat(base), sigma)
        jl = j.global_clip([(n, jax.tree.map(jnp.asarray, x)) for n, x in lst])
        tl = t.global_clip([(n, params_from_jax(x)) for n, x in lst])
        for (_, jt), (_, tt) in zip(jl, tl):
            assert_tree_close(jt, tt, tol=1e-6)
        if t.is_central_dp_enabled():
            g = params_from_jax(glob)
            out = t.add_global_noise(g)
            j.add_global_noise(jax.tree.map(jnp.asarray, glob))
            sigma = {"cdp": t.frame.cdp.sigma if t.frame.cdp else None,
                     "dp_clip": t.frame.sigma() if solution == "dp_clip" else None,
                     "nbafl": t.frame.sigma_d() if solution == "nbafl" else None}[solution]
            assert_draws(_flat(out) - _flat(g), sigma)
        assert abs(t.get_epsilon(1e-5) - j.get_epsilon(1e-5)) <= 1e-12
    assert math.isfinite(t.get_epsilon(1e-5)) and t.get_epsilon(1e-5) > 0


def test_generators_live_on_the_tensors_device():
    t = TDP.get_instance()
    t.init(_args(random_seed=3))
    g = t.generators.for_tree(params_from_jax(_tree(0)))
    assert g.device.type == "cpu" and g.initial_seed() == 3 + 7
    t.add_global_noise(params_from_jax(_tree(0)))
    assert list(t.generators._gens) == [torch.device("cpu")]


@pytest.mark.parametrize("solution", ["dp_clip", "nbafl"])
def test_dp_end_to_end_training_survives(solution):
    """JAX's test_dp_end_to_end_training_survives on the port, JAX's
    threshold: the hook path (anchor, delta clip, fold, central noise)
    still trains."""
    args = fedml_tpu_torch.default_config(
        "simulation", model="lr", dataset="mnist", comm_round=2, epochs=1,
        client_num_in_total=2, client_num_per_round=2, enable_dp=True,
        dp_solution_type=solution, epsilon=100.0, clipping_norm=5.0, noise_multiplier=0.05,
        train_data_num_in_total=1000, using_gpu=False)
    out = fedml_tpu_torch.run_simulation(args=args)
    assert out["test_acc"] > 0.8, out
    assert math.isfinite(TDP.get_instance().get_epsilon(1e-5))


@pytest.mark.parametrize("solution", ["cdp", "ldp"])
def test_dp_through_fedml_runner(solution):
    """cdp and ldp through init and FedMLRunner on the sp front: the model
    trains, and the facade's epsilon is JAX's formula over 2 rounds."""
    from fedml_tpu_torch.core.dp.budget_accountant.rdp_accountant import RDPAccountant

    args = fedml_tpu_torch.init(fedml_tpu_torch.default_config(
        "simulation", model="lr", dataset="mnist", comm_round=2, epochs=1,
        client_num_in_total=2, client_num_per_round=2, enable_dp=True,
        dp_solution_type=solution, epsilon=500.0, clipping_norm=5.0, using_gpu=False))
    dataset, dim = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.model.create(args, dim, device="cpu")
    out = fedml_tpu_torch.FedMLRunner(args, "cpu", dataset, model).run()
    assert out["test_acc"] > 0.8, out
    dp = TDP.get_instance()
    ref = RDPAccountant()
    ref.step(noise_multiplier=dp.frame.get_rdp_scale(), sample_rate=1.0, steps=2)
    assert dp.get_epsilon(1e-5) == ref.get_epsilon(1e-5)


def test_enable_dp_and_privacy_dp_are_independent():
    """``enable_dp`` (the middleware) and ``privacy: dp`` (the accounted
    fold of the cross-silo buffer) are separate knobs in both packages."""
    from fedml_tpu.core.privacy import privacy_from_args as jpriv
    from fedml_tpu_torch.core.privacy import privacy_from_args as tpriv

    mw = _args(dp_solution_type="cdp")
    fold = types.SimpleNamespace(privacy="dp", random_seed=0, client_num_per_round=2,
                                 client_num_in_total=4)
    for priv, facade in ((jpriv, JDP), (tpriv, TDP)):
        assert priv(mw).build_dp() is None
        facade.get_instance().init(fold)
        assert not facade.get_instance().is_dp_enabled()
        assert priv(fold).build_dp() is not None
        facade.get_instance().init(mw)
        assert facade.get_instance().is_dp_enabled()


def _r7_args(pkg, **kw):
    base = dict(model="lr", dataset="mnist", comm_round=2, epochs=1, client_num_in_total=2,
                client_num_per_round=2, frequency_of_the_test=1)
    base.update(kw)
    if pkg is fedml_tpu:
        return jdefault_config("simulation", backend="vmap", **base)
    return fedml_tpu_torch.default_config("simulation", backend="vmap", using_gpu=False, **base)


@pytest.mark.parametrize("knob", [dict(enable_dp=True, dp_solution_type="ldp", epsilon=1.0),
                                  dict(enable_dp=True, dp_solution_type="nbafl"),
                                  dict(enable_attack=True, attack_type="label_flipping")])
def test_r7_vmapped_front_skips_client_hooks(knob):
    """R7: JAX's vmapped front never runs the client hooks. With ldp its
    model is bit-equal to the run without DP while its epsilon grows; the
    port refuses the client-side knobs before any round."""
    if knob.get("dp_solution_type") == "ldp":
        plain = fedml_tpu.run_simulation(backend="vmap", args=_r7_args(fedml_tpu))
        noised = fedml_tpu.run_simulation(backend="vmap", args=_r7_args(fedml_tpu, **knob))
        assert noised["test_loss"] == plain["test_loss"]
        assert JDP.get_instance().get_epsilon(1e-5) > 0
    with pytest.raises(ValueError, match="R7"):
        fedml_tpu_torch.run_simulation(backend="vmap", args=_r7_args(fedml_tpu_torch, **knob))


def test_vmapped_front_runs_server_side_dp():
    """cdp on the vmapped front through run_simulation: the per-client
    branch and the central noise run, and the model still trains."""
    out = fedml_tpu_torch.run_simulation(backend="vmap", args=_r7_args(
        fedml_tpu_torch, enable_dp=True, dp_solution_type="cdp", epsilon=500.0, clipping_norm=5.0))
    assert out["test_acc"] > 0.8
    assert TDP.get_instance().get_epsilon(1e-5) > 0
