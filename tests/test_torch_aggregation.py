"""The port's fold and FedOpt server against the JAX package's, on the CPU.

Tolerances: f32 leaves of the fold within 2e-7 relative to the leaf's
largest magnitude (both accumulate in f32; only the summation order
differs), bf16 leaves within one bf16 ulp (the f32 sums may straddle a
rounding boundary); the FedOpt servers within rtol 1e-6 and atol 1e-6
after three steps (parameters of size ~1, whose f32 ulp is 1.2e-7: torch's
Adam orders its bias corrections otherwise than optax, measured worst
3.9e-7), and so is the Yogi step function against optax.yogi.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.core.aggregation import bucketed as jbucketed
from fedml_tpu.core.aggregation.server_optimizer import FedOptServer as JaxFedOptServer
from fedml_tpu_torch.core.aggregation import bucketed, server_optimizer
from fedml_tpu_torch.core.aggregation.agg_operator import FedMLAggOperator, uniform_average
from fedml_tpu_torch.utils import pytree

SHAPES = {"a": ((5, 3), np.float32), "b": ((7,), "bf16"), "c": ((2, 2, 2), np.float32),
          "d": ((4, 6), "bf16")}


def _trees(k, seed=0):
    """k client trees, the same values as numpy (for JAX) and torch."""
    rng = np.random.default_rng(seed)
    np_trees, torch_trees = [], []
    for _ in range(k):
        nt, tt = {}, {}
        for name, (shape, dtype) in SHAPES.items():
            x = rng.standard_normal(shape).astype(np.float32)
            if dtype == "bf16":
                t = torch.from_numpy(x).to(torch.bfloat16)
                nt[name] = jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                tt[name] = t
            else:
                nt[name], tt[name] = jnp.asarray(x), torch.from_numpy(x)
        np_trees.append(nt)
        torch_trees.append(tt)
    return np_trees, torch_trees


def _assert_fold_close(got, ref):
    for name, (_, dtype) in SHAPES.items():
        r = np.asarray(jnp.asarray(ref[name], jnp.float32))
        g = got[name]
        if dtype == "bf16":
            assert g.dtype == torch.bfloat16
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(r), 1e-30))) - 7)
            assert (np.abs(g.float().numpy() - r) <= ulp).all(), name
        else:
            assert g.dtype == torch.float32
            assert np.abs(g.numpy() - r).max() <= 2e-7 * np.abs(r).max(), name


@pytest.mark.parametrize("k", [1, 16, 19])
def test_bucketed_fold_matches_jax(k):
    """Mixed f32/bf16 leaves, sample-count weights, K=19 leaves a ragged tail
    of 3 past the first bucket of 16."""
    np_trees, torch_trees = _trees(k)
    counts = np.random.default_rng(1).integers(10, 500, k).astype(float)
    ref = jbucketed.BucketedAggregator(16).aggregate(list(zip(counts, np_trees)))
    got = bucketed.BucketedAggregator(16).aggregate(list(zip(counts, torch_trees)))
    _assert_fold_close(got, ref)


def test_fold_is_the_sample_weighted_mean():
    np_trees, torch_trees = _trees(19, seed=2)
    counts = np.arange(1, 20, dtype=float)
    got = FedMLAggOperator.agg(type("A", (), {"federated_optimizer": "FedAvg"})(),
                               list(zip(counts, torch_trees)))
    for name in SHAPES:
        want = sum(c * t[name].double() for c, t in zip(counts, torch_trees)) / counts.sum()
        tol = 1e-6 if got[name].dtype == torch.float32 else 2.0 ** -7
        assert torch.allclose(got[name].double(), want, rtol=tol, atol=tol * want.abs().max())
    mean = uniform_average([t for t in torch_trees[:2]])
    assert torch.allclose(mean["a"], (torch_trees[0]["a"] + torch_trees[1]["a"]) / 2, atol=1e-7)


def test_fold_pads_a_ragged_tail_with_zero_weight():
    """A cohort that leaves its last bucket part-full (3 clients, buckets of
    2) folds to the plain mean: the pad repeats the last client at weight 0."""
    _, torch_trees = _trees(3, seed=4)
    eng = bucketed.BucketedAggregator(2)
    full = eng.aggregate([(1.0, t) for t in torch_trees])
    want = sum(t["a"] for t in torch_trees) / 3
    assert torch.allclose(full["a"], want, atol=1e-6)


def test_unported_rules_raise():
    # every rule of the JAX package's table is ported; an unknown name is refused as there
    with pytest.raises(ValueError, match="unknown federated optimizer"):
        FedMLAggOperator.agg(type("A", (), {"federated_optimizer": "FedNovel"})(), [])
    # object leaves fold with their own + and * (FHE ciphertexts,
    # tests/test_torch_fhe.py); a leaf that defines neither is refused
    with pytest.raises(TypeError):
        bucketed.BucketedAggregator(1).aggregate([(1.0, {"a": object()})])
    with pytest.raises(TypeError, match="object leaves"):
        bucketed.BucketedAggregator(1).accumulate_bucket(None, [{"a": object()}], [1.0])


def test_pytree_helpers():
    _, (a, b) = _trees(2, seed=5)
    a32 = {k: v.float() for k, v in a.items()}
    b32 = {k: v.float() for k, v in b.items()}
    s = pytree.tree_add(a32, b32)
    assert torch.equal(pytree.tree_sub(s, b32)["a"], (a32["a"] + b32["a"]) - b32["a"])
    assert torch.equal(pytree.tree_scale(a32, 2.0)["c"], a32["c"] * 2.0)
    assert all(v.abs().sum() == 0 for v in pytree.tree_zeros_like(a32).values())
    norm = torch.sqrt(sum((v.double() ** 2).sum() for v in a32.values()))
    assert abs(pytree.tree_global_norm(a32).item() - norm.item()) <= 1e-6 * norm.item()
    c = pytree.tree_clone(a32)
    c["a"].add_(1.0)
    assert not torch.equal(c["a"], a32["a"])


class _Args:
    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.mark.parametrize("name", ["sgd", "adam", "yogi"])
def test_fedopt_server_matches_jax_over_three_steps(name):
    rng = np.random.default_rng(7)
    w0 = {"w": rng.standard_normal((6, 4)).astype(np.float32),
          "b": rng.standard_normal((4,)).astype(np.float32)}
    avgs = [{k: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32) for k, v in w0.items()}
            for _ in range(3)]
    args = _Args(server_optimizer=name, server_lr=0.5, server_momentum=0.9)
    jserver = JaxFedOptServer(args, {k: jnp.asarray(v) for k, v in w0.items()})
    tserver = server_optimizer.FedOptServer(args, {k: torch.from_numpy(v) for k, v in w0.items()})
    jw = {k: jnp.asarray(v) for k, v in w0.items()}
    tw = {k: torch.from_numpy(v.copy()) for k, v in w0.items()}
    for avg in avgs:
        jw = jserver.apply(jw, {k: jnp.asarray(v) for k, v in avg.items()})
        t_in = {k: v.clone() for k, v in tw.items()}
        tw_new = tserver.apply(tw, {k: torch.from_numpy(v) for k, v in avg.items()})
        assert all(torch.equal(t_in[k], tw[k]) for k in tw), "apply wrote into its input"
        tw = tw_new
        for k in w0:
            np.testing.assert_allclose(tw[k].numpy(), np.asarray(jw[k]), rtol=1e-6, atol=1e-6)


def test_yogi_step_is_optax_yogi():
    rng = np.random.default_rng(9)
    p = rng.standard_normal(50).astype(np.float32)
    tx = optax.yogi(0.1, b1=0.9, b2=0.99, eps=1e-3)
    state = tx.init(jnp.asarray(p))
    jp, tp, st = jnp.asarray(p), torch.from_numpy(p.copy()), {}
    for _ in range(4):
        g = rng.standard_normal(50).astype(np.float32)
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        server_optimizer.yogi_step(tp, torch.from_numpy(g), st, 0.1, 0.9, 0.99, 1e-3)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)


def test_server_mesh_over_several_devices_raises(monkeypatch):
    template = {"w": torch.zeros(3)}
    args = _Args(server_optimizer="sgd", server_mesh="fsdp:4")
    # on the CPU one device is visible: the spec falls back to one server
    assert isinstance(server_optimizer.create_fedopt_server(args, template),
                      server_optimizer.FedOptServer)
    assert server_optimizer._mesh_devices("auto", 4) == 4
    assert server_optimizer._mesh_devices("dp:2,fsdp:-1", 8) == 8
    assert server_optimizer._mesh_devices("fsdp:1", 8) == 1
    monkeypatch.setattr(server_optimizer, "_visible_devices", lambda device: 4)
    with pytest.raises(NotImplementedError, match="server_mesh"):
        server_optimizer.create_fedopt_server(args, template)
    args.server_mesh = "fsdp:8"  # more than are visible: one server, as in JAX
    assert isinstance(server_optimizer.create_fedopt_server(args, template),
                      server_optimizer.FedOptServer)
