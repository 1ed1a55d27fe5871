"""The port's other sp APIs (FedAvg_seq and its scheduler, TurboAggregate,
split NN and FedGKT with their split models, decentralized DSGD/PushSum
with the topology managers, classical vertical FL) against the JAX
package's, on the CPU, from the same numpy inputs and JAX's parameters
carried across by ``models/convert.py``.

Tolerances:

- the topology matrices, FedAvg_seq's queues for one injected runtime
  history, TurboAggregate's ring output: bit-equal (the ring sum is exact
  field arithmetic, the masks are JAX's generator stream);
- decentralized DSGD and vertical FL, in float64 on both sides: within
  1e-12 of the parameters' scale, the loss histories within 1e-12
  relative; PushSum within 1e-6: its push weights are float32 in both
  packages (JAX's choice), mixed by each package's float32 matmul;
- split NN and FedGKT (float32, Adam): the first step's loss within 1e-5
  relative (the same forward at f32 noise), the later steps' losses within
  1e-3 relative; after each step the median parameter within 1e-5 of JAX's
  and every parameter within ``steps * lr``. optax's and torch's Adam are the same
  update rounded in another order, and an Adam step moves a weight by up to
  lr whatever its gradient's size: a weight whose gradient is of f32-noise
  size moves by a different fraction of lr in each package
  (``simulation/sp/split_nn.py`` states the difference);
- the FedAvg-family runs (FedAvg_seq, TA; LR, 4 clients, 2 rounds):
  test_loss within 1e-4 relative round by round.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.data.dataset import ArrayDataset as JArrayDataset
from fedml_tpu_torch.data.dataset import ArrayDataset as TArrayDataset
from fedml_tpu_torch.models.convert import params_from_jax, params_to_jax

FEDAVG_LR = dict(model="lr", dataset="synthetic", client_num_in_total=4, client_num_per_round=4,
                 comm_round=2, epochs=1, batch_size=16, frequency_of_the_test=1, random_seed=0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small steps: a pool of threads only spins against other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


def _assert_tree_close(got, ref, tol):
    g, r = _leaves(got), _leaves(ref)
    assert sorted(g) == sorted(r)
    for k in r:
        a, b = np.asarray(g[k], np.float64), np.asarray(r[k], np.float64)
        assert a.shape == b.shape, k
        assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30), (k, np.abs(a - b).max())


def _assert_adam_close(got, ref, lr, steps):
    """The later-steps bound of the module docstring."""
    g, r = _leaves(got), _leaves(ref)
    assert sorted(g) == sorted(r)
    d = np.concatenate([np.abs(np.asarray(g[k], np.float64) - np.asarray(r[k], np.float64)).ravel()
                        for k in r])
    assert np.median(d) <= 1e-5 and d.max() <= steps * lr, (np.median(d), d.max())


def _apis(opt, **over):
    """JAX's and the port's sp API for ``opt`` on the same data, the port's
    model from JAX's init parameters."""
    kw = dict(FEDAVG_LR, federated_optimizer=opt, **over)
    jargs = fedml_tpu.init(fedml_tpu.default_config("simulation", **kw))
    jdata, jdim = fedml_tpu.data.load(jargs)
    jmodel = fedml_tpu.model.create(jargs, jdim)
    targs = fedml_tpu_torch.init(fedml_tpu_torch.default_config("simulation", using_gpu=False,
                                                                **kw))
    tdata, tdim = fedml_tpu_torch.data.load(targs)
    tmodel = fedml_tpu_torch.model.create(targs, tdim, device="cpu")
    tmodel.module.load_state_dict(params_from_jax(jax.device_get(jmodel.params)))
    tmodel.params = {k: v.clone() for k, v in tmodel.module.state_dict().items()}
    return (jargs, jdata, jmodel), (targs, tdata, tmodel)


def _run_both(opt, **over):
    (jargs, jdata, jmodel), (targs, tdata, tmodel) = _apis(opt, **over)
    jr = fedml_tpu.FedMLRunner(jargs, "cpu", jdata, jmodel)
    jr.run()
    tr = fedml_tpu_torch.FedMLRunner(targs, torch.device("cpu"), tdata, tmodel)
    tr.run()
    return jr.runner.fl_trainer, tr.runner.fl_trainer


def _assert_history_close(t_api, j_api):
    got, ref = t_api.metrics_history, j_api.metrics_history
    assert [m["round"] for m in got] == [m["round"] for m in ref] == [0, 1]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g["test_loss"], r["test_loss"], rtol=1e-4)
        assert abs(g["test_correct"] - r["test_correct"]) <= 2, (g, r)


# --- dispatch ------------------------------------------------------------------------

@pytest.mark.parametrize("opt,cls", [("TA", "TurboAggregateTrainer"),
                                     ("FedAvg_seq", "FedAvgSeqAPI"),
                                     ("split_nn", "SplitNNAPI"),
                                     ("FedGKT", "FedGKTAPI"),
                                     ("FedGAN", "FedGANAPI"),
                                     ("FedNAS", "FedNASAPI"),
                                     ("FedSeg", "FedSegAPI")])
def test_simulator_dispatches_the_ported_apis(opt, cls):
    from fedml_tpu.simulation.simulator import SimulatorSingleProcess as JSim
    from fedml_tpu_torch.simulation.simulator import SimulatorSingleProcess

    kw = dict(FEDAVG_LR, dataset="mnist", federated_optimizer=opt)
    args = fedml_tpu_torch.init(fedml_tpu_torch.default_config("simulation", using_gpu=False, **kw))
    dataset, dim = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.model.create(args, dim, device="cpu")
    sim = SimulatorSingleProcess(args, torch.device("cpu"), dataset, model)
    assert type(sim.fl_trainer).__name__ == cls
    jargs = fedml_tpu.init(fedml_tpu.default_config("simulation", **kw))
    jdata, jdim = fedml_tpu.data.load(jargs)
    jsim = JSim(jargs, "cpu", jdata, fedml_tpu.model.create(jargs, jdim))
    assert type(jsim.fl_trainer).__name__ == cls


# --- FedAvg_seq --------------------------------------------------------------------------

def test_fedavg_seq_queues_equal_jax_for_one_injected_history():
    (jargs, jdata, jmodel), (targs, tdata, tmodel) = _apis("FedAvg_seq", worker_num=3,
                                                           client_num_in_total=6,
                                                           client_num_per_round=6)
    from fedml_tpu.simulation.sp.fedavg_seq import FedAvgSeqAPI as J
    from fedml_tpu_torch.simulation.sp.fedavg_seq import FedAvgSeqAPI as T

    j, t = J(jargs, "cpu", jdata, jmodel), T(targs, torch.device("cpu"), tdata, tmodel)
    cohort = [5, 0, 3, 1, 4, 2]
    assert t._schedule(cohort) == j._schedule(cohort)  # round 0: cost by sample count
    rng = np.random.default_rng(0)
    for w in range(3):
        for c in range(6):
            times = list(rng.uniform(0.1, 2.0, size=int(rng.integers(1, 4))))
            j.runtime_history[w][c] = list(times)
            t.runtime_history[w][c] = list(times)
    for sizes in (None, {0: 800, 1: 100, 2: 100, 3: 100, 4: 100, 5: 800}):
        if sizes:
            j.train_data_local_num_dict = {**j.train_data_local_num_dict, **sizes}
            t.train_data_local_num_dict = {**t.train_data_local_num_dict, **sizes}
        tq, tl = t._schedule(cohort)
        jq, jl = j._schedule(cohort)
        assert tq == jq and tl == jl
        assert sorted(i for q in tq for i in q) == list(range(6))


def test_fedavg_seq_run_tracks_jax():
    j, t = _run_both("FedAvg_seq", worker_num=2)
    _assert_history_close(t, j)
    assert t.metrics_history[0]["schedule"] == j.metrics_history[0]["schedule"]
    for m in t.metrics_history:
        assert sorted(i for q in m["schedule"] for i in q) == list(range(4))
        assert m["makespan"] > 0
    assert any(t.runtime_history[w] for w in range(t.worker_num))


def test_fedavg_seq_refuses_structured_payloads():
    (_, _, _), (targs, tdata, tmodel) = _apis("FedAvg_seq")
    from fedml_tpu_torch.simulation.sp.fedavg_seq import FedAvgSeqAPI

    targs.federated_optimizer = "SCAFFOLD"
    with pytest.raises(ValueError, match="SCAFFOLD"):
        FedAvgSeqAPI(targs, torch.device("cpu"), tdata, tmodel)


# --- TurboAggregate ----------------------------------------------------------------------

def _cohort_trees(k, seed=0):
    rng = np.random.default_rng(seed)
    return [{"Dense_0": {"kernel": rng.normal(0, 0.3, (6, 4)).astype(np.float32),
                         "bias": rng.normal(0, 0.3, (4,)).astype(np.float32)},
             "Conv_0": {"kernel": rng.normal(0, 0.3, (3, 3, 2, 5)).astype(np.float32)}}
            for _ in range(k)]


@pytest.mark.parametrize("k,groups", [(4, 2), (5, 3), (16, 4)])
def test_ta_ring_sum_bit_equal_to_jax(k, groups):
    """The ring's output from the same updates, sample counts and seed is
    bit-equal to JAX's; the ring sum equals the plain field sum of the same
    quantized updates (the masks cancel)."""
    from fedml_tpu.simulation.sp.turboaggregate import TurboAggregateTrainer as J
    from fedml_tpu_torch.core.mpc.finite_field import flatten_finite, tree_to_finite
    from fedml_tpu_torch.simulation.sp.turboaggregate import _P, _Q_BITS
    from fedml_tpu_torch.simulation.sp.turboaggregate import TurboAggregateTrainer as T
    from fedml_tpu_torch.utils.pytree import tree_scale

    trees = _cohort_trees(k, seed=k)
    counts = [float(n) for n in np.random.default_rng(k).integers(10, 500, k)]
    j, t = J.__new__(J), T.__new__(T)  # the ring reads only args
    j.args = t.args = types.SimpleNamespace(ta_group_num=groups, random_seed=3)
    want = j._ring_aggregate(list(zip(counts, trees)))
    tl = [(n, params_from_jax(tree)) for n, tree in zip(counts, trees)]
    got = t._ring_aggregate(tl)
    g, r = _leaves(params_to_jax(got)), _leaves(jax.device_get(want))
    for key in r:
        assert g[key].dtype == np.float32 and np.array_equal(g[key], r[key]), key
    total = sum(counts)
    plain = sum(flatten_finite(tree_to_finite(tree_scale(w, n / total), _Q_BITS, _P))
                for n, w in tl) % _P
    assert torch.equal(t._ring_sum(tl), plain)


def test_ta_run_tracks_jax():
    j, t = _run_both("TA", ta_group_num=2)
    _assert_history_close(t, j)


# --- decentralized -----------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(5, 2), (8, 4), (12, 6)])
def test_topology_matrices_bit_equal(n, k):
    from fedml_tpu.core.distributed import topology as jtop
    from fedml_tpu_torch.core.distributed import topology as ttop

    for make in (lambda m: m.SymmetricTopologyManager(n, k),
                 lambda m: m.AsymmetricTopologyManager(n, k, 2, seed=n)):
        a, b = make(jtop), make(ttop)
        a.generate_topology()
        b.generate_topology()
        assert np.array_equal(a.mixing_matrix(), b.mixing_matrix())
        for i in range(n):
            assert a.get_in_neighbor_idx_list(i) == b.get_in_neighbor_idx_list(i)
            assert a.get_out_neighbor_weights(i) == b.get_out_neighbor_weights(i)


def _stream(n_clients, N, d, seed):
    rng = np.random.RandomState(seed)
    w_true = rng.randn(d)
    x = rng.randn(n_clients, N, d)
    return x, (x @ w_true > 0).astype(np.float64)


@pytest.mark.parametrize("symmetric", [True, False])
def test_decentralized_dsgd_and_pushsum_in_float64(symmetric):
    from fedml_tpu.simulation.sp.decentralized import FedML_decentralized_fl as jrun
    from fedml_tpu_torch.simulation.sp.decentralized import FedML_decentralized_fl as trun

    n, N, d = 6, 40, 5
    x, y = _stream(n, N, d, seed=1)
    args = types.SimpleNamespace(b_symmetric=symmetric, iteration_number=40, learning_rate=0.3,
                                 batch_size=4, topology_neighbors_num_undirected=2,
                                 topology_neighbors_num_directed=2)

    def jloss(params, xb, yb):
        logit = xb @ params["w"] + params["b"]
        return jnp.mean(jnp.maximum(logit, 0) - logit * yb + jnp.log1p(jnp.exp(-jnp.abs(logit))))

    def tloss(params, xb, yb):
        logit = xb @ params["w"] + params["b"]
        return torch.mean(torch.clamp(logit, min=0) - logit * yb
                          + torch.log1p(torch.exp(-torch.abs(logit))))

    w0 = np.random.default_rng(2).normal(0, 0.1, d)
    with jax.enable_x64(True):
        ref = jrun(n, (x, y), {"w": jnp.asarray(w0), "b": jnp.zeros((), jnp.float64)}, jloss, args)
        ref_w = {k: np.asarray(v) for k, v in ref["params"].items()}
    got = trun(n, (x, y), {"w": torch.from_numpy(w0), "b": torch.zeros((), dtype=torch.float64)},
               tloss, args, device="cpu")
    for k, v in got["params"].items():
        assert v.dtype == torch.float64 and v.shape == ref_w[k].shape
    tol = 1e-12 if symmetric else 1e-6
    _assert_tree_close({k: v.numpy() for k, v in got["params"].items()}, ref_w, tol)
    np.testing.assert_allclose(got["loss_history"], ref["loss_history"], rtol=tol)
    assert got["loss_history"][-1] < got["loss_history"][0]


# --- vertical FL -------------------------------------------------------------------------

def test_vertical_fl_in_float64_tracks_jax():
    from fedml_tpu.simulation.sp.classical_vertical_fl import VerticalFederatedLearning as JV
    from fedml_tpu.simulation.sp.classical_vertical_fl import VflFixture as JF
    from fedml_tpu_torch.simulation.sp.classical_vertical_fl import VerticalFederatedLearning as TV
    from fedml_tpu_torch.simulation.sp.classical_vertical_fl import VflFixture as TF

    rng = np.random.RandomState(0)
    n, dims = 300, (4, 6, 3)
    xs = [rng.randn(n, d) for d in dims]
    y = ((sum(x @ rng.randn(x.shape[1]) for x in xs)) > 0).astype(np.float64)
    tr, te = slice(0, 220), slice(220, None)
    with jax.enable_x64(True):
        jv = JV(list(dims), learning_rate=0.5)
        jv.party_params = [{k: jnp.asarray(np.asarray(v, np.float64)) for k, v in p.items()}
                           for p in jv.party_params]
        init = [{k: np.asarray(v) for k, v in p.items()} for p in jv.party_params]
        jm = JF(jv).fit([x[tr] for x in xs], y[tr], [x[te] for x in xs], y[te], epochs=3,
                        batch_size=32)
    tv = TV(list(dims), learning_rate=0.5, device="cpu", dtype=torch.float64)
    tv.party_params = [{k: torch.from_numpy(v) for k, v in p.items()} for p in init]
    tf = TF(tv)
    tm = tf.fit([x[tr] for x in xs], y[tr], [x[te] for x in xs], y[te], epochs=3, batch_size=32)
    assert tm["test_acc"] == jm["test_acc"] and tm["test_acc"] > 0.8
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-12)
    for tp, jp in zip(tv.party_params, jv.party_params):
        _assert_tree_close({k: v.numpy() for k, v in tp.items()},
                           {k: np.asarray(v) for k, v in jp.items()}, 1e-12)


# --- split NN and FedGKT -----------------------------------------------------------------

def _image_dataset(pkg_ds, n_clients=2, n=96, n_test=64, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda m: pkg_ds(rng.normal(0, 1, (m, 32, 32, 3)).astype(np.float32),
                          rng.integers(0, 10, m).astype(np.int64))
    tr = {c: mk(n) for c in range(n_clients)}
    return [n * n_clients, n_test, None, mk(n_test), {c: n for c in range(n_clients)}, tr,
            dict(tr), 10]


def _split_args(pkg, opt, **over):
    kw = dict(federated_optimizer=opt, dataset="cifar10", client_num_in_total=2, comm_round=1,
              epochs=1, batch_size=32, learning_rate=0.05, random_seed=0, **over)
    if pkg is fedml_tpu_torch:
        kw["using_gpu"] = False
    return pkg.default_config("simulation", **kw)


def test_split_nn_first_steps_track_jax():
    from fedml_tpu.simulation.sp.split_nn import SplitNNAPI as J
    from fedml_tpu_torch.simulation.sp.split_nn import SplitNNAPI as T

    j = J(_split_args(fedml_tpu, "split_nn"), None, _image_dataset(JArrayDataset))
    t = T(_split_args(fedml_tpu_torch, "split_nn"), torch.device("cpu"),
          _image_dataset(TArrayDataset))
    t.client_net.load_state_dict(params_from_jax(jax.device_get(j.client_params)))
    t.server_net.load_state_dict(params_from_jax(jax.device_get(j.server_params)))
    # the converter carries both halves by name: the same names and shapes
    for net, ref in ((t.client_net, j.client_params), (t.server_net, j.server_params)):
        assert {k: np.shape(v) for k, v in _leaves(params_to_jax(net)).items()} == \
            {k: np.shape(v) for k, v in _leaves(jax.device_get(ref)).items()}
    data = t.train_local[0]
    steps = []
    for bx, by in data.batches(32, shuffle=True, seed=0, drop_last=True):
        feats = j._client_forward(j.client_params, jnp.asarray(bx))
        j.server_params, j.opt_s, g, loss = j._server_step(j.server_params, j.opt_s, feats,
                                                           jnp.asarray(by))
        j.client_params, j.opt_c = j._client_backward(j.client_params, j.opt_c, jnp.asarray(bx), g)
        steps.append((float(loss), float(t._step(torch.from_numpy(bx), torch.from_numpy(by)))))
        n = len(steps)
        _assert_adam_close(params_to_jax(t.client_net), jax.device_get(j.client_params), 1e-3, n)
        _assert_adam_close(params_to_jax(t.server_net), jax.device_get(j.server_params), 1e-3, n)
    assert len(steps) == 3
    np.testing.assert_allclose(steps[0][1], steps[0][0], rtol=1e-5)
    for ref, got in steps[1:]:
        np.testing.assert_allclose(got, ref, rtol=1e-3)
    m = t._test()
    assert m["test_total"] == 64.0 and 0.0 <= m["test_acc"] <= 1.0


def test_fedgkt_first_round_tracks_jax():
    from fedml_tpu.simulation.sp.fedgkt import FedGKTAPI as J
    from fedml_tpu_torch.simulation.sp.fedgkt import FedGKTAPI as T

    j = J(_split_args(fedml_tpu, "FedGKT"), None, _image_dataset(JArrayDataset))
    t = T(_split_args(fedml_tpu_torch, "FedGKT"), torch.device("cpu"),
          _image_dataset(TArrayDataset))
    for cid, net in enumerate(t.client_nets):
        net.load_state_dict(params_from_jax(jax.device_get(j.client_params[cid])))
    t.server_net.load_state_dict(params_from_jax(jax.device_get(j.server_params)))
    assert np.array_equal(t._batches(96, 5), np.asarray(j._batches(96, 5)))
    ref = j.train()
    got = t.train()
    for key in ("client_loss", "server_loss"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-3)
    assert got["test_total"] == ref["test_total"] == 64.0
    # 3 client steps (96 samples, bs 32) and 6 server steps at Adam's 1e-3
    _assert_adam_close(params_to_jax(t.server_net), jax.device_get(j.server_params), 1e-3, 6)
    for cid, net in enumerate(t.client_nets):
        _assert_adam_close(params_to_jax(net), jax.device_get(j.client_params[cid]), 1e-3, 3)


def test_kl_soft_equals_jax():
    from fedml_tpu.simulation.sp.fedgkt import _kl_soft
    from fedml_tpu_torch.simulation.sp.fedgkt import kl_soft

    rng = np.random.default_rng(0)
    s, t = rng.normal(0, 3, (2, 16, 10)).astype(np.float32)
    np.testing.assert_allclose(float(kl_soft(torch.from_numpy(s), torch.from_numpy(t), 3.0)),
                               float(_kl_soft(jnp.asarray(s), jnp.asarray(t), 3.0)), rtol=1e-6)
