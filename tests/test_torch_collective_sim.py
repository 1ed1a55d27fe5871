"""The port's Parrot-NCCL and Parrot-MPI simulators against the JAX
package's, on the CPU.

``fedml_tpu_torch/simulation/collective/`` (backend ``NCCL``) against JAX's
``CollectiveSimulator`` on the 8 virtual CPU devices, and
``simulation/mpi_sim.py`` (backend ``MPI``) against JAX's
``FedMLDistributedRunner``. LR on the MNIST surrogate (JAX's
``tests/test_collective_sim.py`` shape: 8 clients, 2 rounds, batch 32, lr
0.03) and on the synthetic set (JAX's ``tests/test_simulators.py`` MPI
shape: 2 clients, 2 rounds, batch 16), from JAX's initial params.
Tolerances:

- NCCL with one group is the vmapped round: metrics and final params
  bit-equal to ``backend: vmap``;
- NCCL in 2 to 4 groups (``devices`` repeating the CPU) against the vmapped
  round: the final params within 1e-6 of their scale (only the fold's f32
  summation order differs: each group's partial sum is rounded before the
  reduce; measured 2.4e-7); the groups' count follows JAX's divisor rule;
- NCCL in 1 and 4 groups against JAX's collective simulator over as many
  devices: each eval's test_loss within rtol 1e-5 and test_correct within 1,
  the final params within 1e-5 of their scale (the LR parity level of
  ``tests/test_torch_cross_silo.py``; measured 2.4e-7 and test_loss 4.2e-8);
- MPI threaded against JAX's MPI run: the final metrics within the same
  limits; launched externally (a server and 2 client processes over the
  ``MPI`` backend, which is GRPC between processes): metrics equal to the
  threaded run's, bit for bit.
"""

import json
import os
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.simulation.collective import CollectiveSimulator as JCollective
from fedml_tpu_torch.core.distributed.communication.ip_config import free_port_block
from fedml_tpu_torch.core.distributed.fedml_comm_manager import _run_id_offset
from fedml_tpu_torch.models.convert import params_from_jax, params_to_jax
from fedml_tpu_torch.simulation.collective import CollectiveSimulator as TCollective
from fedml_tpu_torch.tools.launch_silo import launch

NCCL = dict(dataset="mnist", model="lr", comm_round=2, epochs=1, batch_size=32,
            learning_rate=0.03, client_num_in_total=8, client_num_per_round=8,
            frequency_of_the_test=1, random_seed=0, data_cache_dir="")
MPI = dict(comm_round=2, client_num_in_total=2, client_num_per_round=2, epochs=1, batch_size=16,
           frequency_of_the_test=1, dataset="synthetic", model="lr", random_seed=0,
           data_cache_dir="")
PARAM_TOL, LOSS_RTOL = 1e-5, 1e-5
GROUPS_TOL = 1e-6
DEADLINE_S = 120


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


def _of_scale(got, ref):
    g, r = _leaves(got), _leaves(ref)
    assert sorted(g) == sorted(r)
    return max(float(np.abs(np.asarray(g[k], np.float64) - np.asarray(r[k], np.float64)).max()
                   / np.abs(np.asarray(r[k], np.float64)).max()) for k in r)


def _assert_metrics_close(got, ref):
    assert got["test_total"] == ref["test_total"]
    np.testing.assert_allclose(got["test_loss"], ref["test_loss"], rtol=LOSS_RTOL)
    assert abs(got["test_correct"] - ref["test_correct"]) <= 1, (got, ref)


def _jax_parts(kw, backend):
    args = fedml_tpu.init(fedml_tpu.default_config("simulation", backend=backend, **kw))
    dataset, output_dim = fedml_tpu.data.load(args)
    return args, dataset, fedml_tpu.model.create(args, output_dim)


def _port_parts(kw, backend, p0):
    args = fedml_tpu_torch.init(fedml_tpu_torch.default_config(
        "simulation", backend=backend, using_gpu=False, **kw))
    dataset, output_dim = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.model.create(args, output_dim, device="cpu")
    model.module.load_state_dict(params_from_jax(p0))
    model.params = {k: v.detach().clone() for k, v in model.module.state_dict().items()}
    return args, dataset, model


def _port_run(kw, backend, p0):
    args, dataset, model = _port_parts(kw, backend, p0)
    runner = fedml_tpu_torch.FedMLRunner(args, torch.device("cpu"), dataset, model)
    runner.run()
    api = runner.runner.fl_trainer
    return api, api.metrics_history, api.model.params


@pytest.fixture(scope="module")
def p0_nccl():
    _, _, model = _jax_parts(NCCL, "NCCL")
    return jax.device_get(model.params)


def test_nccl_one_group_is_the_vmapped_round_bit_for_bit(p0_nccl):
    """On one device (the CPU here, the one visible card on the H100) the
    NCCL backend runs one group: the vmapped round itself."""
    api, hist, w = _port_run(NCCL, "NCCL", p0_nccl)
    assert type(api).__name__ == "CollectiveSimulator" and len(api.devices) == 1
    _, ref_hist, ref_w = _port_run(NCCL, "vmap", p0_nccl)
    assert hist == ref_hist
    assert list(w) == list(ref_w) and all(torch.equal(w[k], ref_w[k]) for k in w)


@pytest.mark.parametrize("n_devices,groups", [(2, 2), (3, 2), (4, 4)])
def test_nccl_groups_equal_the_vmapped_round_within_f32(p0_nccl, n_devices, groups):
    """Several groups on one device (``devices`` repeating it): the groups'
    count follows JAX's divisor rule (3 devices for 8 clients: 2), and the
    result is the vmapped round's up to the fold's f32 summation order."""
    jargs, jdata, jmodel = _jax_parts(NCCL, "NCCL")
    jsim = JCollective(jargs, "cpu", jdata, jmodel, devices=jax.devices()[:n_devices])
    assert jsim.mesh.devices.size == groups
    args, dataset, model = _port_parts(NCCL, "NCCL", p0_nccl)
    sim = TCollective(args, torch.device("cpu"), dataset, model, devices=["cpu"] * n_devices)
    assert len(sim.devices) == groups
    m = sim.train()
    _, ref_hist, ref_w = _port_run(NCCL, "vmap", p0_nccl)
    assert m["round"] == ref_hist[-1]["round"] == 1
    _assert_metrics_close(m, ref_hist[-1])
    assert _of_scale(params_to_jax(sim.model.params), params_to_jax(ref_w)) <= GROUPS_TOL


@pytest.mark.parametrize("groups", [1, 4])
def test_nccl_tracks_jax_collective_simulator(p0_nccl, groups):
    jargs, jdata, jmodel = _jax_parts(NCCL, "NCCL")
    jmodel.params = p0_nccl
    jsim = JCollective(jargs, "cpu", jdata, jmodel, devices=jax.devices()[:groups])
    jsim.train()
    args, dataset, model = _port_parts(NCCL, "NCCL", p0_nccl)
    sim = TCollective(args, torch.device("cpu"), dataset, model, devices=["cpu"] * groups)
    sim.train()
    assert [m["round"] for m in sim.metrics_history] == \
        [m["round"] for m in jsim.metrics_history] == [0, 1]
    for g, r in zip(sim.metrics_history, jsim.metrics_history):
        _assert_metrics_close(g, r)
    assert _of_scale(params_to_jax(sim.model.params), jax.device_get(jsim.model.params)) \
        <= PARAM_TOL


def test_run_simulation_nccl_and_fedml_collective_init():
    """The one-liner on the CPU and the reference's init name."""
    from fedml_tpu_torch.simulation.collective import FedML_Collective_init

    args = fedml_tpu_torch.default_config("simulation", using_gpu=False, **NCCL)
    out = fedml_tpu_torch.run_simulation(backend="NCCL", args=args)
    assert out["round"] == 1 and np.isfinite(out["test_loss"])
    dataset, output_dim = fedml_tpu_torch.data.load(args)
    sim = FedML_Collective_init(args, "cpu", dataset,
                                fedml_tpu_torch.model.create(args, output_dim, device="cpu"))
    assert isinstance(sim, TCollective) and sim.devices == [torch.device("cpu")]


def _jax_mpi(kw):
    args, dataset, model = _jax_parts(kw, "MPI")
    p0 = jax.device_get(model.params)
    return p0, fedml_tpu.FedMLRunner(args, "cpu", dataset, model).run()


def _port_mpi(kw, p0):
    args, dataset, model = _port_parts(kw, "MPI", p0)
    runner = fedml_tpu_torch.FedMLRunner(args, torch.device("cpu"), dataset, model)
    assert type(runner.runner).__name__ == "SimulatorMPI"
    assert not runner.runner.runner.launched_externally
    return runner.run()


def test_mpi_threaded_tracks_jax():
    """Server and clients as threads over INMEMORY in both packages."""
    kw = dict(MPI, run_id="tcol_mpi_threads")
    p0, ref = _jax_mpi(kw)
    got = _port_mpi(kw, p0)
    assert got["round"] == ref["round"] == 1
    _assert_metrics_close(got, ref)


MPI_RANK = textwrap.dedent(
    """
    import json, os, sys
    sys.path.insert(0, os.environ["REPO_ROOT"])
    import numpy as np, torch
    torch.set_num_threads(1)
    import fedml_tpu_torch as fedml

    spec = json.loads(sys.argv[1])
    p0 = {k: torch.from_numpy(v) for k, v in np.load(spec["p0"]).items()}
    create = fedml.model.create

    def from_p0(args, output_dim=None, seed=None, device=None):
        model = create(args, output_dim, seed, device)
        model.module.load_state_dict(p0)
        model.params = {k: v.detach().clone() for k, v in model.module.state_dict().items()}
        return model

    fedml.model.create = from_p0
    args = fedml.default_config("simulation", **spec["config"])
    out = fedml.run_simulation(backend="MPI", args=args)
    print("RESULT " + json.dumps(out))
    """
)


def test_mpi_launched_externally_equals_threaded(tmp_path):
    """One rank a process (``process_group_launched``), GRPC among them
    through the ``MPI`` backend: the server's final metrics equal the
    threaded run's."""
    pytest.importorskip("grpc")
    kw = dict(MPI, run_id="tcol_mpi_procs")
    p0 = jax.device_get(_jax_parts(kw, "MPI")[2].params)
    threaded = _port_mpi(dict(kw, run_id="tcol_mpi_ref"), p0)
    np.savez(tmp_path / "p0.npz", **{k: v.numpy() for k, v in params_from_jax(p0).items()})
    (tmp_path / "rank.py").write_text(MPI_RANK)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["REPO_ROOT"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = free_port_block(3) - _run_id_offset(kw["run_id"])
    ranks = []
    try:
        for rank in (1, 2, 0):
            spec = {"p0": str(tmp_path / "p0.npz"),
                    "config": dict(kw, rank=rank, role="server" if rank == 0 else "client",
                                   process_group_launched=True, grpc_base_port=base,
                                   using_gpu=False)}
            ranks.append(launch([sys.executable, str(tmp_path / "rank.py"), json.dumps(spec)], 1,
                                env=env, log_dir=str(tmp_path / f"rank{rank}")))
        rcs = [r.wait(DEADLINE_S) for r in ranks]
        assert rcs == [[0], [0], [0]], [(tmp_path / f"rank{r}" / "rank0.err").read_text()[-2000:]
                                        for r in (1, 2, 0)]
    finally:
        for r in ranks:
            r.kill()
    out = (tmp_path / "rank0" / "rank0.out").read_text().split("RESULT ")[-1]
    assert json.loads(out) == threaded
