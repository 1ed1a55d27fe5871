"""The port's contribution assessment
(``fedml_tpu_torch/core/contribution``) against the JAX package's, on the
CPU.

Each valuation runs in both packages over the same client models and a
fixed metric of the averaged model (a weighted sum of its leaves). The
subset models are each package's own f32 fold, so the valuations agree
within 1e-5 of the metric's scale; the GTG permutations come from JAX's
numpy seed. The Shapley axioms (efficiency, symmetry) hold to 1e-9 on the
port's exact values.

R9 (ROADMAP.md, Queue 3) is shown on both sides: JAX's contribution hook
fails on the sp front (its metric returns the test dict), the port's values
the clients by the subset model's ``test_acc``.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.arguments import default_config as jdefault_config
from fedml_tpu.core.alg_frame.context import Context as JContext
from fedml_tpu.core.contribution import contribution_assessor_manager as jcam
from fedml_tpu_torch.core.alg_frame.context import Context as TContext
from fedml_tpu_torch.core.contribution import contribution_assessor_manager as tcam
from tests.test_torch_security import middleware_off, one_torch_thread  # noqa: F401

VALUE_TOL = 1e-5


def _models(vals, weights=None, seed=0):
    """Client models of two leaves: ``w`` (the client's value, shifted) and a
    random vector; numpy for JAX, tensors for the port."""
    rng = np.random.default_rng(seed)
    weights = weights or [1.0 + i for i in range(len(vals))]
    trees = [{"w": np.full((3,), v, np.float32), "u": rng.normal(size=(4,)).astype(np.float32)}
             for v in vals]
    jl = [(w, {k: jnp.asarray(a) for k, a in t.items()}) for w, t in zip(weights, trees)]
    tl = [(w, {k: torch.from_numpy(a) for k, a in t.items()}) for w, t in zip(weights, trees)]
    return jl, tl


def _metric(params):
    return float(np.asarray(params["w"]).sum() + 0.1 * np.asarray(params["u"]).sum())


def _tmetric(params):
    return float(params["w"].sum() + 0.1 * params["u"].sum())


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=VALUE_TOL * max(1.0, float(np.abs(b).max())))


@pytest.mark.parametrize("vals", [[3.0, 3.0, 0.0], [4.0, 2.0, 0.0, -1.0], [1.0, 1.0, -2.0, 5.0]])
def test_loo_and_exact_shapley_are_jax_values(vals):
    jl, tl = _models(vals)
    _close(tcam.leave_one_out(tl, _tmetric), jcam.leave_one_out(jl, _metric))
    phi = tcam.exact_shapley(tl, _tmetric, empty_metric=0.5)
    _close(phi, jcam.exact_shapley(jl, _metric, empty_metric=0.5))
    full = _tmetric(tcam.weighted_average(tl))
    assert abs(sum(phi) - (full - 0.5)) <= 1e-9 * max(1.0, abs(full))  # efficiency


def test_exact_shapley_symmetry():
    _, tl = _models([3.0, 3.0, 0.0])
    tl[1] = (tl[0][0], {k: v.clone() for k, v in tl[0][1].items()})
    phi = tcam.exact_shapley(tl, _tmetric)
    assert abs(phi[0] - phi[1]) <= 1e-9 and phi[2] < phi[0]


@pytest.mark.parametrize("seed,max_perms,eps", [(0, 50, 1e-9), (3, None, 1e-3), (7, 5, 0.5)])
def test_gtg_shapley_is_jax_gtg(seed, max_perms, eps):
    jl, tl = _models([4.0, 2.0, 0.0, 1.0, -3.0], seed=seed)
    got = tcam.gtg_shapley(tl, _tmetric, 0.25, eps=eps, max_perms=max_perms, seed=seed)
    _close(got, jcam.gtg_shapley(jl, _metric, 0.25, eps=eps, max_perms=max_perms, seed=seed))


def test_multi_round_modes_keyed_by_client_id():
    rounds = [{3: 1.0, 7: 0.0}, {3: 1.0, 9: 2.0}]
    for mode in ("sum", "last_round_weighted"):
        assert tcam.multi_round_shapley(rounds, mode) == jcam.multi_round_shapley(rounds, mode)
    assert tcam.multi_round_shapley([], "sum") == {}
    with pytest.raises(ValueError):
        tcam.multi_round_shapley(rounds, "bogus")


@pytest.mark.parametrize("alg,k", [("loo", 4), ("mr_shapley", 4), ("shapley", 13), ("gtg", 5)])
def test_manager_dispatch_and_history_follow_jax(alg, k):
    """The manager's dispatch (exact Shapley up to 12 clients, GTG above),
    keyed by the round's client ids from Context, over two rounds."""
    args = types.SimpleNamespace(enable_contribution=True, contribution_alg=alg)
    jm, tm = jcam.ContributionAssessorManager(args), tcam.ContributionAssessorManager(args)
    for r in range(2):
        ids = list(range(10 * r, 10 * r + k))
        JContext().add("client_indexes_of_round", ids)
        TContext().add("client_indexes_of_round", ids)
        jl, tl = _models([float(i % 5) - 1.0 for i in range(k)], seed=r)
        _close(tm.run(tl, None, _tmetric), jm.run(jl, None, _metric))
    assert [sorted(h) for h in tm.get_history()] == [sorted(h) for h in jm.get_history()]
    final = tm.get_final_contribution("sum")
    _close([final[c] for c in sorted(final)],
           [jm.get_final_contribution("sum")[c] for c in sorted(final)])
    assert tcam.ContributionAssessorManager(types.SimpleNamespace()).run(tl, None, _tmetric) is None


def _contribution_args(pkg, **kw):
    base = dict(model="lr", dataset="mnist", comm_round=2, epochs=1, client_num_in_total=3,
                client_num_per_round=3, enable_contribution=True, contribution_alg="loo",
                enable_attack=True, attack_type="byzantine", attack_mode="flip",
                byzantine_client_num=1)
    base.update(kw)
    if pkg is fedml_tpu:
        return jdefault_config("simulation", **base)
    return fedml_tpu_torch.default_config("simulation", using_gpu=False, **base)


def test_r9_contribution_hook_values_the_subset_models():
    """R9: JAX's hook subtracts the test dicts its metric returns and fails;
    the port's values each client by the subset model's test_acc. The
    flipped attacker (client 0) gets the lowest leave-one-out value."""
    with pytest.raises(TypeError, match="dict"):
        fedml_tpu.run_simulation(args=_contribution_args(fedml_tpu))
    args = fedml_tpu_torch.init(_contribution_args(fedml_tpu_torch))
    dataset, dim = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.model.create(args, dim, device="cpu")
    runner = fedml_tpu_torch.FedMLRunner(args, "cpu", dataset, model)
    runner.run()
    agg = runner.runner.fl_trainer.aggregator
    history = agg._contribution_manager.get_history()
    assert len(history) == 2 and all(len(h) == 3 for h in history)
    last = history[-1]
    assert min(last, key=last.get) == TContext().get("client_indexes_of_round")[0]
    # the subset models went back out: the aggregator holds the round's global
    w = runner.runner.fl_trainer.model_trainer.get_model_params()
    assert all(torch.equal(agg.get_model_params()[k], w[k]) for k in w)


def test_contribution_runs_on_the_vmapped_front(monkeypatch):
    """JAX's vmapped front never calls the contribution hook (its stacked
    sink folds without it; R9). The port's unstacks the cohort and values
    every client each round by id, as on the sp front: the flipped attacker
    (client 0) gets the lowest leave-one-out value."""
    from fedml_tpu.core.alg_frame.server_aggregator import ServerAggregator as JServerAggregator

    calls = []
    monkeypatch.setattr(JServerAggregator, "assess_contribution", lambda self: calls.append(1))
    out = fedml_tpu.run_simulation(backend="vmap", args=_contribution_args(fedml_tpu))
    assert np.isfinite(out["test_loss"]) and calls == []
    args = fedml_tpu_torch.init(_contribution_args(fedml_tpu_torch, backend="vmap"))
    dataset, dim = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.model.create(args, dim, device="cpu")
    runner = fedml_tpu_torch.FedMLRunner(args, "cpu", dataset, model)
    runner.run()
    api = runner.runner.fl_trainer
    assert type(api).__name__ == "VmapFedAvgAPI"
    history = api.aggregator._contribution_manager.get_history()
    assert len(history) == 2 and all(len(h) == 3 for h in history)
    last = history[-1]
    assert min(last, key=last.get) == TContext().get("client_indexes_of_round")[0]
