"""The port's process-group plane against the JAX package's, on the CPU.

``fedml_tpu_torch/parallel/{mesh,multihost,dp}.py`` against
``fedml_tpu/parallel/{mesh,multihost,dp}.py``. Process groups are never
initialised inside a test worker: ranks are subprocesses started by
``fedml_tpu_torch/tools/launch_silo.py`` (the reference launcher's
environment, a rendezvous port from ``ip_config.free_port_block``), joined
over gloo on the CPU, each under a deadline. Tolerances:

- the 2-rank slice (after JAX's ``tests/test_multihost.py``): the metadata
  rounds exact, exactly one rank opens the WAN, every leaf of a state dict
  (an int64 buffer among them) broadcast bit for bit, an oversized object
  refused with JAX's ``ValueError``;
- the data-parallel local round of 2 ranks against JAX's unsharded
  trainer (``make_local_train_fn`` under ``ClassificationTrainer``,
  ``FedProxTrainer``, ``ScaffoldTrainer``), both packages in float64 (LR on
  the synthetic set, 20 examples in batches of 16: the last batch's 4 real
  rows all in rank 0's half, so rank 1's share is all padding), momentum
  SGD with weight decay: the trained weights (and SCAFFOLD's control
  variate update) within 1e-9 of the update's scale (both packages are
  exact to about 1e-15 here; f32 would hide a fault behind 1e-7 noise);
  the reported loss equal to the one-rank round's within 1e-12 on every
  rank; a batch that 2 ranks do not divide refused with ``ValueError`` as
  JAX's sharded call refuses it.
"""

import json
import os
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.data.dataset import ArrayDataset as JArrayDataset
from fedml_tpu.ml.trainer import trainer_creator as jcreator
from fedml_tpu.parallel import mesh as jmesh
from fedml_tpu.parallel import multihost as jmh
from fedml_tpu_torch.models.convert import params_from_jax, params_to_jax
from fedml_tpu_torch.parallel import mesh as tmesh
from fedml_tpu_torch.parallel import multihost as tmh
from fedml_tpu_torch.tools.launch_silo import launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 120
DP_TOL = 1e-9
LOSS_TOL = 1e-12

DP_BASE = dict(random_seed=0, dataset="synthetic", data_cache_dir="", model="lr",
               client_num_in_total=2, client_num_per_round=2, epochs=2, batch_size=16,
               client_optimizer="sgd", learning_rate=0.1, momentum=0.9, weight_decay=0.001)
DP_CASES = {"padding": dict(federated_optimizer="FedAvg"),
            "fedprox": dict(federated_optimizer="FedProx", fedprox_mu=0.1),
            "scaffold": dict(federated_optimizer="SCAFFOLD")}
SHARD = 20  # examples: batches of 16 and 4 (+12 padded rows, all in rank 1's half)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["REPO_ROOT"] = ROOT
    return env


def _run_ranks(script: str, tmp_path, args=(), nproc: int = 2) -> list:
    """``script`` as ranks 0..nproc-1 of one group; each must exit 0 within
    DEADLINE_S. Returns each rank's stdout."""
    path = tmp_path / "rank_main.py"
    path.write_text(script)
    silo = launch([sys.executable, str(path), *map(str, args)], nproc, env=_env(),
                  log_dir=str(tmp_path / "logs"))
    rcs = silo.wait(DEADLINE_S)
    outs = [(tmp_path / "logs" / f"rank{r}.out").read_text() for r in range(nproc)]
    errs = [(tmp_path / "logs" / f"rank{r}.err").read_text()[-3000:] for r in range(nproc)]
    assert rcs == [0] * nproc, errs
    return outs


# --- one process: the helpers degrade as JAX's do ------------------------------------

def test_single_process_fallbacks():
    """Without a coordinator both packages stay single-process: init returns
    False (also for num_processes 2 without an address, the lifted
    ``num_processes > 1`` gate), this process is the main one and the
    broadcasts hand back what they were given."""
    assert jmh.init_distributed() is False
    assert tmh.init_distributed() is False
    assert tmh.init_distributed(num_processes=2, process_id=1) is False
    assert not tmh.is_initialized() and tmh.backend() is None
    assert tmh.is_main_process() is jmh.is_main_process() is True
    assert tmh.process_count() == jmh.process_count() == 1
    meta = {"model_version": 3, "finished": False}
    assert tmh.broadcast_round_metadata(meta) == jmh.broadcast_round_metadata(meta) == meta
    params = {"w": torch.arange(3.0)}
    assert tmh.broadcast_model_params(params) is params
    tmh.sync_process_group()
    args = fedml_tpu_torch.init(fedml_tpu_torch.default_config(
        "simulation", using_gpu=False, num_processes=2))
    assert args.num_processes == 2 and not tmh.is_initialized()


@pytest.mark.parametrize("world,device,count,want", [
    (2, "cpu", 0, "gloo"), (2, "cuda:0", 1, "gloo"), (4, "cuda:0", 2, "gloo"),
    (2, "cuda:0", 2, "nccl"), (1, "cuda:0", 8, "nccl"), (8, "cuda:3", 8, "nccl")])
def test_collective_backend_rule(world, device, count, want):
    """NCCL only when every rank has a card of its own; gloo when ranks share
    a card or compute on the CPU."""
    assert tmh.collective_backend(world, torch.device(device), count) == want


def test_rank_device_is_the_cpu_only_when_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmh.rank_device(3, "cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmh.rank_device(1)


@pytest.mark.parametrize("shape,names", [((8,), ("dp",)), ((2, 4), ("dp", "fsdp")),
                                         ((2, 2, 2), ("dp", "fsdp", "tp"))])
def test_mesh_shapes_match_jax(shape, names):
    """The port's device grid has JAX's mesh shape and axis names over the
    same count of devices, and JAX's error past it."""
    jdev = jax.devices()[:8]
    tdev = ["cpu"] * 8
    jm = {1: jmesh.dp_mesh, 2: jmesh.fsdp_mesh, 3: jmesh.tp_mesh}[len(shape)]
    tm = {1: tmesh.dp_mesh, 2: tmesh.fsdp_mesh, 3: tmesh.tp_mesh}[len(shape)]
    ref = jm(devices=jdev) if len(shape) == 1 else jm(*shape, devices=jdev)
    got = tm(devices=tdev) if len(shape) == 1 else tm(*shape, devices=tdev)
    assert dict(ref.shape) == got.shape == dict(zip(names, shape))
    assert got.axis_names == tuple(ref.axis_names)
    with pytest.raises(ValueError) as jerr:
        jmesh.create_mesh((3, 3), ("a", "b"), jdev)
    with pytest.raises(ValueError) as terr:
        tmesh.create_mesh((3, 3), ("a", "b"), tdev)
    assert str(terr.value) == str(jerr.value) == "mesh needs 9 devices, have 8"


# --- two ranks --------------------------------------------------------------------------

SLICE_WORKER = textwrap.dedent(
    """
    import json, os, sys
    sys.path.insert(0, os.environ["REPO_ROOT"])
    import torch
    from fedml_tpu_torch.parallel import multihost as mh
    from fedml_tpu_torch.parallel.mesh import dp_mesh

    out_dir = sys.argv[1]
    assert mh.init_distributed(device="cpu")
    rank = mh.process_index()
    assert mh.process_count() == 2 and mh.backend() == "gloo"
    mesh = dp_mesh()
    got = {"mesh": [list(mesh.mesh.shape), list(mesh.mesh_dim_names)]}
    if mh.is_main_process():
        # exactly one process opens the WAN connection
        open(os.path.join(out_dir, f"wan_opened_by_{rank}"), "w").write("connected")
        for r in range(3):
            mh.broadcast_round_metadata({"model_version": r, "client_index": 7, "finished": False})
        mh.broadcast_round_metadata({"finished": True})
        params = {"w": torch.linspace(-1, 1, 7, dtype=torch.float64).reshape(7, 1),
                  "b": torch.full((2,), 0.5), "steps": torch.tensor([41], dtype=torch.int64)}
        try:
            mh.broadcast_round_metadata({"blob": "x" * (1 << 16)})
        except ValueError as e:
            got["oversize"] = str(e)
        got["role"] = "master"
    else:
        got["role"], got["rounds"] = "slave", []
        while True:
            meta = mh.broadcast_round_metadata(None)
            if meta["finished"]:
                break
            got["rounds"].append(meta)
        params = {"w": torch.zeros(7, 1, dtype=torch.float64), "b": torch.zeros(2),
                  "steps": torch.zeros(1, dtype=torch.int64)}
    out = mh.broadcast_model_params(params)
    mh.sync_process_group()
    got["params"] = {k: v.tolist() for k, v in out.items()}
    got["dtypes"] = {k: str(v.dtype) for k, v in out.items()}
    got["stats"] = mh.collective_stats()
    mh.shutdown_distributed()
    with open(os.path.join(out_dir, f"result_{rank}.json"), "w") as f:
        json.dump(got, f)
    """
)


def test_two_rank_slice_one_wan_talker(tmp_path):
    _run_ranks(SLICE_WORKER, tmp_path, args=(tmp_path,))
    assert os.path.exists(tmp_path / "wan_opened_by_0")
    assert not os.path.exists(tmp_path / "wan_opened_by_1")
    master, slave = (json.loads((tmp_path / f"result_{r}.json").read_text()) for r in (0, 1))
    assert master["role"] == "master" and slave["role"] == "slave"
    assert [m["model_version"] for m in slave["rounds"]] == [0, 1, 2]
    assert all(m["client_index"] == 7 for m in slave["rounds"])
    # every leaf, the int64 buffer included, bit for bit and in its dtype
    assert slave["params"] == master["params"]
    assert slave["dtypes"] == master["dtypes"] == {"w": "torch.float64", "b": "torch.float32",
                                                   "steps": "torch.int64"}
    assert master["params"]["steps"] == [41]
    # JAX's framing and error: a 64 KiB buffer, 4 bytes of length
    assert master["oversize"] == f"round metadata too large: {(1 << 16) + 12} bytes"
    meta_bytes = 4 * (1 << 16)
    for r in (master, slave):
        assert r["mesh"] == [[2], ["dp"]]
        assert r["stats"]["broadcast_round_metadata"] == {"calls": 4, "bytes": meta_bytes}
        assert r["stats"]["broadcast_model_params"]["calls"] == 3  # one a dtype
        assert r["stats"]["barrier"]["calls"] == 1


DP_WORKER = textwrap.dedent(
    """
    import json, os, sys
    sys.path.insert(0, os.environ["REPO_ROOT"])
    import numpy as np, torch
    torch.set_num_threads(1)
    import fedml_tpu_torch as fedml
    from fedml_tpu_torch.data.dataset import ArrayDataset
    from fedml_tpu_torch.ml.trainer.trainer_creator import create_model_trainer
    from fedml_tpu_torch.parallel import multihost as mh
    from fedml_tpu_torch.parallel.dp import DataParallelGroup, shard_local_train
    from fedml_tpu_torch.parallel.mesh import dp_mesh

    out_dir = sys.argv[1]
    assert mh.init_distributed(device="cpu")
    rank = mh.process_index()
    spec = json.loads(open(os.path.join(out_dir, "spec.json")).read())
    data = np.load(os.path.join(out_dir, "inputs.npz"))
    shard = ArrayDataset(data["x"], data["y"])
    res = {}
    for case, over in spec["cases"].items():
        args = fedml.default_config("simulation", using_gpu=False, round_idx=0,
                                    **dict(spec["base"], **over))
        for width in (1, 2):
            model = fedml.model.create(args, int(spec["classes"]), device="cpu")
            model.module.to(torch.float64)
            p0 = {k: torch.from_numpy(data["p0/" + k]) for k in model.module.state_dict()}
            trainer = create_model_trainer(model, args)
            trainer.set_model_params(p0)
            trainer.set_id(0)
            if case == "scaffold":
                trainer.set_control_variate(
                    {k: torch.from_numpy(data["c/" + k]) for k in p0})
            if width == 2:
                # the DeviceMesh form of JAX's (fn, mesh) for one case
                mesh = dp_mesh() if case == "padding" else DataParallelGroup(2, rank)
                trainer._local_train = shard_local_train(trainer._local_train, mesh)
            trainer.train(shard, "cpu", args)
            key = f"{case}/{width}"
            for k, v in trainer.get_model_params().items():
                res[f"{key}/w/{k}"] = v.numpy()
            if case == "scaffold":
                for k, v in trainer.c_local.items():
                    res[f"{key}/c/{k}"] = v.numpy()
            res[f"{key}/loss"] = np.float64(trainer.last_loss)
    # a batch the 2 ranks do not divide
    args = fedml.default_config("simulation", using_gpu=False, round_idx=0,
                                **dict(spec["base"], batch_size=15))
    model = fedml.model.create(args, int(spec["classes"]), device="cpu")
    trainer = create_model_trainer(model, args)
    trainer._local_train = shard_local_train(trainer._local_train, DataParallelGroup(2, rank))
    try:
        trainer.train(ArrayDataset(data["x"].astype(np.float32), data["y"]), "cpu", args)
    except ValueError as e:
        res["odd_batch_error"] = np.str_(str(e))
    res["stats"] = np.str_(json.dumps(mh.collective_stats()))
    mh.shutdown_distributed()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    """
)


def _jax_dp_reference(tmp_path):
    """JAX's unsharded trainers on the same shard, in float64, and the
    inputs the ranks read: JAX's initial params in the port's layout."""
    kw = dict(DP_BASE)
    jargs = fedml_tpu.init(fedml_tpu.default_config("simulation", **kw))
    dataset, classes = fedml_tpu.data.load(jargs)
    src = dataset[5][0]
    x, y = np.asarray(src.x[:SHARD], np.float64), np.asarray(src.y[:SHARD])
    p0 = jax.device_get(fedml_tpu.model.create(jargs, classes).params)
    rng = np.random.default_rng(5)
    c_global = jax.tree.map(lambda a: rng.normal(0.0, 0.1, np.shape(a)), p0)
    ref = {}
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
        for case, over in DP_CASES.items():
            args = fedml_tpu.default_config("simulation", **dict(kw, **over))
            args.round_idx = 0
            model = fedml_tpu.model.create(args, classes)
            model.params = f64(p0)
            trainer = jcreator.create_model_trainer(model, args)
            trainer.set_model_params(f64(p0))
            trainer.set_id(0)
            if case == "scaffold":
                trainer.set_control_variate(f64(c_global))
            trainer.train(JArrayDataset(x, y), "cpu", args)
            ref[case] = {"w": jax.device_get(trainer.get_model_params()),
                         "c": jax.device_get(trainer.c_local) if case == "scaffold" else None}
    arrays = {"x": x, "y": y}
    arrays.update({f"p0/{k}": v.numpy().astype(np.float64) for k, v in params_from_jax(p0).items()})
    arrays.update({f"c/{k}": v.numpy().astype(np.float64)
                   for k, v in params_from_jax(c_global).items()})
    np.savez(tmp_path / "inputs.npz", **arrays)
    (tmp_path / "spec.json").write_text(json.dumps(
        {"base": DP_BASE, "cases": DP_CASES, "classes": int(classes)}))
    return p0, ref


@pytest.fixture(scope="module")
def dp_round(tmp_path_factory):
    """JAX's unsharded rounds, and each case trained by one rank and by two
    (one pair of rank processes for every case)."""
    tmp = tmp_path_factory.mktemp("dp")
    p0, ref = _jax_dp_reference(tmp)
    _run_ranks(DP_WORKER, tmp, args=(tmp,))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in (0, 1)]
    return p0, ref, ranks


def _tree(ranks_npz, prefix):
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in ranks_npz.items()
            if k.startswith(prefix)}


def _of_update(got, ref, start):
    g, r, s = (jax.tree.leaves(t) for t in (got, ref, start))
    num = max(float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())
              for a, b in zip(g, r))
    den = max(float(np.abs(np.asarray(b, np.float64) - np.asarray(c, np.float64)).max())
              for b, c in zip(r, s))
    return num / den


@pytest.mark.parametrize("case", list(DP_CASES))
def test_dp_local_round_matches_jax_unsharded(dp_round, case):
    """Two ranks splitting every batch train what JAX's unsharded round
    trains: the global loss normaliser over the padded batch, FedProx's
    proximal term and SCAFFOLD's correction once, weight decay once; params
    stay replicated; the reported loss is the whole batch's."""
    p0, ref, ranks = dp_round
    for rank in ranks:
        got = params_to_jax(_tree(rank, f"{case}/2/w/"))
        one = params_to_jax(_tree(rank, f"{case}/1/w/"))
        assert _of_update(got, ref[case]["w"], p0) <= DP_TOL
        assert _of_update(one, ref[case]["w"], p0) <= DP_TOL
        if case == "scaffold":
            zeros = jax.tree.map(np.zeros_like, p0)
            assert _of_update(params_to_jax(_tree(rank, f"{case}/2/c/")), ref[case]["c"],
                              zeros) <= DP_TOL
        assert abs(float(rank[f"{case}/2/loss"]) - float(rank[f"{case}/1/loss"])) <= LOSS_TOL
    for k in ranks[0]:  # replicated: both ranks hold the same bits
        if k.startswith(f"{case}/2/"):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k])


def test_dp_refuses_a_batch_the_ranks_do_not_divide(dp_round):
    """JAX's sharded call raises ValueError on a batch dimension the dp axis
    does not divide (its pjit check); so does the port's DP round, on every
    rank, before any collective. The DP rounds above ran one all-reduce a
    step and nothing else."""
    from fedml_tpu.parallel.dp import shard_local_train
    from fedml_tpu.parallel.mesh import dp_mesh

    f = shard_local_train(lambda p, x, y, idx, mask, rng, ex: (idx * mask).sum(), dp_mesh(2))
    with pytest.raises(ValueError, match="divisible by 2"):
        f(1.0, jnp.zeros(3), jnp.zeros(3), np.zeros((1, 2, 15), np.int32),
          np.ones((1, 2, 15), np.float32), jax.random.PRNGKey(0), 0)
    _, _, ranks = dp_round
    for rank in ranks:
        assert "global size 15 is not divisible by the 2 ranks" in str(rank["odd_batch_error"])
        stats = json.loads(str(rank["stats"]))
        steps = 2 * 2  # 2 epochs of 2 batches
        assert set(stats) == {"dp_all_reduce"}
        assert stats["dp_all_reduce"]["calls"] == steps * len(DP_CASES)
