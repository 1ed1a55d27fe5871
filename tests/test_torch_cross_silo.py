"""The port's cross-silo front against the JAX package's, on the CPU.

Each federation runs every party (server rank 0, clients 1..N) as a thread
of this process through FedMLRunner, over its own run_id; every thread is
joined within JOIN_S and a party still alive fails the test. Tolerances:

- the port against JAX, LR on the synthetic set (tests/test_cross_silo.py's
  shape: 2 clients, 2 rounds, INMEMORY), the port's server starting from the
  JAX server's initial params: each round's test_loss within rtol 1e-5 and
  test_correct within 1 of 24, the final params within 1e-5 of their scale
  (Parrot config 1's parity level; measured 1.6e-7, test_loss 4.7e-8);
- a small CNN (CNNCifar) in float64 on both sides, as the vmapped
  simulator's ResNet parity tests run (f32 noise of the training dynamics
  would hide a fault), 2 clients, 2 rounds, momentum SGD with weight decay:
  test_loss within rtol 1e-7 and test_correct equal, the final params'
  update within 5e-5 of JAX's (those tests' limits; both folds accumulate in
  f32, and here they meet exactly: measured 0.0, test_loss equal);
- the port against itself: cross-silo against the sp simulator (with the sp
  trainer's seed rule pinned to the round index, as the cross-silo trainer's
  is) and MQTT_S3 against INMEMORY, bit for bit;
- a JAX server with two port clients over a JAX socket broker: its final
  params within 1e-5 of their scale of the all-JAX run's;
- async rounds (``async_rounds``, LR, 2 clients, a publish every 3 merges,
  3 publishes), the uploads put in one order on both sides by a turnstile:
  the same verdicts and client versions arrival by arrival, each publish
  and the final params within 1e-5 of their scale of JAX's, each eval's
  test_loss within rtol 1e-5 (the synchronous LR limits; measured 1.7e-7
  and 3.7e-8); a JAX async server with port clients, and a port async
  server with JAX clients, over the socket broker: the same arrivals as
  the all-JAX async run and final params within 1e-5 of its;
- the uplink compressor: eftopk at ratio 1.0 bit-equal to the uncompressed
  run (metrics and params), and topk at ratio 0.25 finishing with finite
  metrics (tests/test_cross_silo.py's two compressor cases);
- privacy (``privacy``): an async ``secagg`` federation (LR, 2 clients, 3
  masked windows) with the model uploads put in one order on both sides:
  every publish within one ``QuantSpec.step`` of JAX's at every coordinate
  (both packages train to within f32 noise, about 1e-7, so a coordinate
  near a rounding edge of the quantization grid lands one step apart, a
  member's step over the cohort's size in the mean); a JAX async secagg
  server with port clients over the socket broker, within one step of the
  all-JAX run; the dropout drill (tests/test_privacy.py's message-plane
  drill) closing its windows partial after the survivors' reveals; a
  synchronous ``dp`` federation whose clipped mean before the noise tracks
  JAX's within 1e-5 of its scale round by round (the port's run is given
  JAX's realized noise, so both trajectories stay one), while the port's own
  draws pass the statistics test (std within 10% of z·C/n over 1,220 draws,
  mean within 4 sigma/sqrt(d)) and its accountant's epsilon equals JAX's;
- the hierarchical silo (``scenario: hierarchical``) through
  ``run_hierarchical_cross_silo_server`` and ``_client``: a server process
  and 2 silos of 2 processes each (ranks joined over gloo by
  ``tools/launch_silo.py``, the parties over MQTT_S3 through a socket broker
  hosted here), LR as above from JAX's initial params, 2 rounds: the final
  params within 1e-5 of their scale of JAX's ``scenario: hierarchical`` run
  (its local rounds sharded over the 8 virtual CPU devices), both with the
  silos' batches split over 2 ranks and with ``n_proc_in_silo`` 1 (rank 0
  unsharded, rank 1 training the whole batch beside it); the broker
  accepted 3 connections (the server and each silo's rank 0: exactly one
  WAN talker a silo).
"""

import contextlib
import copy
import importlib
import json
import os
import sys
import textwrap
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.core.distributed.communication.inmemory.broker import InMemoryBroker as JBroker
from fedml_tpu.core.distributed.communication.mqtt_s3.socket_broker import SocketMqttBroker
from fedml_tpu.data import data_loader as jloader
from fedml_tpu.data.dataset import ArrayDataset as JArrayDataset
from fedml_tpu_torch.core import telemetry as tel
from fedml_tpu_torch.core.distributed.communication.inmemory.broker import InMemoryBroker
from fedml_tpu_torch.core.distributed.communication.ip_config import free_port_block
from fedml_tpu_torch.core.distributed.communication.mqtt_s3.mqtt_transport import LocalMqttBroker
from fedml_tpu_torch.core.distributed.fedml_comm_manager import _run_id_offset
from fedml_tpu_torch.data import data_loader as tloader
from fedml_tpu_torch.data.dataset import ArrayDataset as TArrayDataset
from fedml_tpu_torch.models.convert import params_from_jax, params_to_jax
from fedml_tpu_torch.core.distributed.communication.mqtt_s3.socket_broker import (
    SocketMqttBroker as TSocketBroker)
from fedml_tpu_torch.tools.launch_silo import launch

JOIN_S = 120
MODEL_TO_SERVER = 3  # MSG_TYPE_C2S_SEND_MODEL_TO_SERVER in both packages

LR = dict(client_num_in_total=2, client_num_per_round=2, comm_round=2, epochs=1,
          batch_size=16, frequency_of_the_test=1, dataset="synthetic", model="lr",
          random_seed=0, scenario="horizontal", data_cache_dir="")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Several parties train at once in each federation; under several test
    workers a pool of threads in each only spins against the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _max_err_of_scale(got, ref):
    g, r = _leaves(got), _leaves(ref)
    assert sorted(g) == sorted(r)
    return max(float(np.abs(_np(g[k]).astype(np.float64) - _np(r[k])).max()
                     / np.abs(_np(r[k])).max()) for k in r)


class Federation:
    """Build every party's runner through the package's own entry points
    (init, get_device, data.load, model.create, FedMLRunner), then run them
    as threads. ``load(args)`` replaces ``data.load``; ``prepare(role, rank,
    args, dataset, model)`` may swap the model before the runner is built."""

    def __init__(self, pkg, run_id, kw, backend="INMEMORY", roles=None, prepare=None, load=None):
        self.pkg, self.results, self.errors = pkg, {}, {}
        n = int(kw["client_num_per_round"])
        self.runners = {}
        for rank in range(n + 1):
            role = "server" if rank == 0 else "client"
            if roles is not None and roles.get(rank, pkg) is not pkg:
                continue
            over = dict(kw, run_id=run_id, rank=rank, role=role, backend=backend)
            if pkg is fedml_tpu_torch:
                over["using_gpu"] = False
            args = pkg.init(pkg.default_config("cross_silo", **over))
            dev = pkg.device.get_device(args) if pkg is fedml_tpu else pkg.get_device(args)
            dataset, output_dim = (load or pkg.data.load)(args)
            model = pkg.model.create(args, output_dim) if pkg is fedml_tpu else \
                pkg.model.create(args, output_dim, device=dev)
            if prepare is not None:
                dataset, model = prepare(role, rank, args, dataset, model)
            self.runners[rank] = pkg.FedMLRunner(args, dev, dataset, model)

    @property
    def server(self):
        return self.runners[0].runner.server_manager

    def client_trainer(self, rank):
        return self.runners[rank].runner.client_manager.trainer_dist_adapter.trainer.trainer

    def _party(self, rank):
        try:
            self.results[rank] = self.runners[rank].run()
        except BaseException as e:  # reported by run(); the thread must not hang the test
            self.errors[rank] = e
            raise

    def run(self, others=()):
        threads = [threading.Thread(target=self._party, args=(r,), daemon=True,
                                    name=f"party-{r}") for r in self.runners]
        for t in list(threads) + list(others):
            t.start()
        for t in list(threads) + list(others):
            t.join(JOIN_S)
            assert not t.is_alive(), f"{t.name} still running after {JOIN_S}s: deadlock"
        assert not self.errors, self.errors
        return self


def _record_evals(fed):
    """Every server eval's metrics, by round."""
    agg = fed.server.aggregator
    hist = []
    test = agg.test_on_server_for_all_clients

    def recorded(round_idx):
        m = test(round_idx)
        if m is not None:
            hist.append(dict(m))
        return m

    agg.test_on_server_for_all_clients = recorded
    return hist


def _global(fed):
    return fed.server.aggregator.get_global_model_params()


def _jax_p0(kw):
    args = fedml_tpu.init(fedml_tpu.default_config("cross_silo", **kw))
    _, output_dim = fedml_tpu.data.load(args)
    return jax.device_get(fedml_tpu.model.create(args, output_dim).params)


def _from_jax_params(p0, dtype=None):
    def prepare(role, rank, args, dataset, model):
        model.module.load_state_dict(params_from_jax(p0))
        if dtype is not None:
            model.module.to(dtype)
        model.params = {k: v.detach().clone() for k, v in model.module.state_dict().items()}
        return dataset, model
    return prepare


def _assert_hist_close(got, ref, rtol, acc_slack):
    assert [m["round"] for m in got] == [m["round"] for m in ref] == [0, 1]
    for g, r in zip(got, ref):
        assert g["test_total"] == r["test_total"]
        np.testing.assert_allclose(g["test_loss"], r["test_loss"], rtol=rtol)
        assert abs(g["test_correct"] - r["test_correct"]) <= acc_slack, (g, r)


def _run_jax(run_id, kw, backend="INMEMORY", prepare=None, load=None):
    JBroker.reset(run_id)
    fed = Federation(fedml_tpu, run_id, kw, backend=backend, prepare=prepare, load=load)
    hist = _record_evals(fed)
    fed.run()
    JBroker.reset(run_id)
    return fed, hist, jax.device_get(_global(fed))


def _run_port(run_id, kw, backend="INMEMORY", prepare=None, load=None):
    InMemoryBroker.reset(run_id)
    LocalMqttBroker.reset(run_id)
    fed = Federation(fedml_tpu_torch, run_id, kw, backend=backend, prepare=prepare, load=load)
    hist = _record_evals(fed)
    fed.run()
    InMemoryBroker.reset(run_id)
    LocalMqttBroker.reset(run_id)
    return fed, hist, {k: v.detach().clone() for k, v in _global(fed).items()}


def test_lr_federation_tracks_jax_round_by_round():
    p0 = _jax_p0(LR)
    _, ref_hist, ref_w = _run_jax("tcs_jax_lr", LR)
    fed, hist, w = _run_port("tcs_port_lr", LR, prepare=_from_jax_params(p0))
    _assert_hist_close(hist, ref_hist, rtol=1e-5, acc_slack=1)
    assert fed.server.final_metrics == hist[-1]
    assert _max_err_of_scale(params_to_jax(w), ref_w) <= 1e-5
    for k, v in w.items():
        assert v.device.type == "cpu" and v.dtype == torch.float32, k


def _small_cifar_f64(load, ds_cls, args):
    """A loader for the parties: the CIFAR-10 surrogate in 2 hetero shards
    cut to their first 24 examples (a full and a part-masked batch), the
    test set to 64 (a cut of scale, for CPU time); images in float64. Loaded
    once, handed to every party."""
    d = load(args)
    local = {c: ds_cls(s.x[:24].astype(np.float64), s.y[:24]) for c, s in d[5].items()}
    test = ds_cls(d[3].x[:64].astype(np.float64), d[3].y[:64])
    data = (sum(len(s) for s in local.values()), 64, d[2], test,
            {c: len(s) for c, s in local.items()}, local, {c: test for c in local}, d[7])
    return lambda party_args: (data, d[7])


def test_cnn_federation_in_float64_tracks_jax():
    kw = dict(LR, dataset="cifar10", model="cnn_cifar", partition_method="hetero",
              partition_alpha=0.5, learning_rate=0.01, momentum=0.9, weight_decay=5e-4)
    p0 = _jax_p0(kw)

    def jprep(role, rank, args, dataset, model):
        model.params = jax.tree.map(lambda leaf: jnp.asarray(leaf, jnp.float64), p0)
        return dataset, model

    jload = _small_cifar_f64(jloader.load, JArrayDataset, fedml_tpu.default_config("cross_silo", **kw))
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)  # global: the parties run on their own threads
    try:
        _, ref_hist, ref_w = _run_jax("tcs_jax_cnn", kw, prepare=jprep, load=jload)
    finally:
        jax.config.update("jax_enable_x64", prev)
    tload = _small_cifar_f64(tloader.load, TArrayDataset,
                             fedml_tpu_torch.default_config("cross_silo", **kw))
    _, hist, w = _run_port("tcs_port_cnn", kw, prepare=_from_jax_params(p0, torch.float64),
                           load=tload)
    assert all(v.dtype == torch.float64 for v in w.values())
    assert [m["round"] for m in hist] == [m["round"] for m in ref_hist] == [0, 1]
    for g, r in zip(hist, ref_hist):
        assert g["test_total"] == r["test_total"] and g["test_correct"] == r["test_correct"]
        np.testing.assert_allclose(g["test_loss"], r["test_loss"], rtol=1e-7)
    g, r, s = _leaves(params_to_jax(w)), _leaves(ref_w), _leaves(p0)
    num = sum(float(np.sum((np.asarray(g[k], np.float64) - np.asarray(r[k], np.float64)) ** 2))
              for k in r)
    den = sum(float(np.sum((np.asarray(r[k], np.float64) - np.asarray(s[k], np.float64)) ** 2))
              for k in r)
    assert den > 0 and (num / den) ** 0.5 <= 5e-5


def test_cross_silo_equals_the_sp_simulator():
    """Full cohort, same seed: the sp simulator's trainer seeds each local
    round from its own call counter unless args.round_idx is set, and the
    cross-silo trainer sets it to the round index; with the sp side's
    round_idx pinned to the round, both runs train the same steps on the same
    data from the same params, and the final params are equal bit for bit."""
    _, hist, w = _run_port("tcs_port_vs_sp", LR)
    args = fedml_tpu_torch.init(fedml_tpu_torch.default_config(
        "simulation", **dict(LR, backend="sp", using_gpu=False)))
    dataset, output_dim = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.model.create(args, output_dim, device="cpu")
    runner = fedml_tpu_torch.FedMLRunner(args, torch.device("cpu"), dataset, model)
    api = runner.runner.fl_trainer
    sample = api._client_sampling

    def pinned(round_idx, total, per_round):
        args.round_idx = round_idx
        return sample(round_idx, total, per_round)

    api._client_sampling = pinned
    runner.run()
    sp_w = api.model_trainer.get_model_params()
    assert list(sp_w) == list(w)
    for k in w:
        assert torch.equal(sp_w[k], w[k]), k
    assert [{k: m[k] for k in ("round", "test_loss", "test_correct")} for m in api.metrics_history] \
        == [{k: m[k] for k in ("round", "test_loss", "test_correct")} for m in hist]


def test_mqtt_s3_equals_inmemory(tmp_path):
    """The transport is invisible: the same seeded run over MQTT_S3 (the
    local broker, the object store, the wire layout both ways) and over
    INMEMORY gives equal metrics and params, bit for bit."""
    _, hist_a, wa = _run_port("tcs_det_a", LR)
    kw = dict(LR, object_store_dir=str(tmp_path / "store"))
    fed, hist_b, wb = _run_port("tcs_det_b", kw, backend="MQTT_S3")
    assert hist_a == hist_b
    assert list(wa) == list(wb) and all(torch.equal(wa[k], wb[k]) for k in wa)
    assert len(list((tmp_path / "store").iterdir())) == 2 * 2 + 2 * 2  # 2 rounds x (2 down + 2 up)


HIER_PARTY = textwrap.dedent(
    """
    import json, os, sys
    sys.path.insert(0, os.environ["REPO_ROOT"])
    import numpy as np, torch
    torch.set_num_threads(1)
    import fedml_tpu_torch as fedml
    from fedml_tpu_torch import runner as runner_mod
    from fedml_tpu_torch.parallel import multihost as mh

    spec = json.loads(sys.argv[1])
    p0 = {k: torch.from_numpy(v) for k, v in np.load(spec["p0"]).items()}
    create = fedml.model.create

    def from_p0(args, output_dim=None, seed=None, device=None):
        model = create(args, output_dim, seed, device)
        model.module.load_state_dict(p0)
        model.params = {k: v.detach().clone() for k, v in model.module.state_dict().items()}
        return model

    fedml.model.create = from_p0
    built = {}
    run = runner_mod.FedMLRunner.run

    def recorded(self):
        built["runner"] = self.runner
        if hasattr(self.runner, "client_manager"):
            # read before the silo's group is torn down at the end of run
            built["rank"], built["ranks"] = mh.process_index(), mh.process_count()
        return run(self)

    runner_mod.FedMLRunner.run = recorded
    args = fedml.default_config("cross_silo", **spec["config"])
    if args.role == "server":
        fedml.run_hierarchical_cross_silo_server(args)
        w = built["runner"].server_manager.aggregator.get_global_model_params()
        np.savez(spec["out"], **{k: v.numpy() for k, v in w.items()})
        print("RESULT " + json.dumps({"role": "server"}))
    else:
        fedml.run_hierarchical_cross_silo_client(args)
        manager = built["runner"].client_manager
        print("RESULT " + json.dumps({
            "rank": built["rank"], "ranks": built["ranks"], "manager": type(manager).__name__,
            "dp_width": manager.trainer_dist_adapter.dp_width, "stats": mh.collective_stats()}))
    """
)


@pytest.mark.parametrize("n_proc_in_silo", [0, 1])
def test_hierarchical_silos_track_jax(n_proc_in_silo, tmp_path):
    """A 2-rank silo (``n_proc_in_silo`` 0: all its ranks) splits every
    batch over its ranks; with ``n_proc_in_silo`` 1 rank 0 trains unsharded
    and rank 1, outside the group, trains the whole batch beside it. Either
    way the federation is JAX's hierarchical one, and only each silo's rank
    0 opens the WAN."""
    kw = dict(LR, scenario="hierarchical", n_proc_in_silo=n_proc_in_silo)
    p0 = _jax_p0(kw)
    _, _, ref_w = _run_jax(f"tcs_jax_hier{n_proc_in_silo}", kw)
    np.savez(tmp_path / "p0.npz", **{k: v.numpy() for k, v in params_from_jax(p0).items()})
    script = tmp_path / "party.py"
    script.write_text(HIER_PARTY)
    broker = TSocketBroker(port=0)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["REPO_ROOT"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parties = []
    try:
        for rank in (1, 2, 0):
            spec = {"p0": str(tmp_path / "p0.npz"), "out": str(tmp_path / "global.npz"),
                    "config": dict(kw, rank=rank, role="server" if rank == 0 else "client",
                                   run_id=f"tcs_hier{n_proc_in_silo}", backend="MQTT_S3",
                                   mqtt_socket=broker.address, using_gpu=False,
                                   object_store_dir=str(tmp_path / "store"))}
            parties.append(launch([sys.executable, str(script), json.dumps(spec)],
                                  1 if rank == 0 else 2, env=env,
                                  log_dir=str(tmp_path / f"party{rank}")))
        rcs = [p.wait(JOIN_S) for p in parties]
        errs = {d.name: [(d / f).read_text()[-2000:] for f in os.listdir(d) if f.endswith(".err")]
                for d in tmp_path.iterdir() if d.name.startswith("party") and d.is_dir()}
        assert rcs == [[0, 0], [0, 0], [0]], errs
        assert broker.accepted == 3  # the server and one rank a silo
    finally:
        for p in parties:
            p.kill()
        broker.stop()
    got = {k: torch.from_numpy(v) for k, v in np.load(tmp_path / "global.npz").items()}
    assert _max_err_of_scale(params_to_jax(got), ref_w) <= 1e-5
    width = 2 if n_proc_in_silo == 0 else 1
    for silo in (1, 2):
        reports = [json.loads((tmp_path / f"party{silo}" / f"rank{r}.out").read_text()
                              .split("RESULT ")[-1]) for r in (0, 1)]
        assert [r["manager"] for r in reports] == ["ClientMasterManager", "ClientSlaveManager"]
        assert [(r["rank"], r["ranks"]) for r in reports] == [(0, 2), (1, 2)]
        assert [r["dp_width"] for r in reports] == [width, 1 if width == 1 else 2]
        for r in reports:  # 2 rounds: metadata and params each round, then finished
            assert r["stats"]["broadcast_round_metadata"]["calls"] == 3
            assert r["stats"]["broadcast_model_params"]["calls"] == 2
            assert ("dp_all_reduce" in r["stats"]) == (width == 2)


def test_jax_server_with_port_clients_over_the_socket_broker(tmp_path):
    """A JAX server and two port clients, each a thread, over a JAX
    SocketMqttBroker with one shared object store: the run completes and its
    final params match the all-JAX run of the same config."""
    _, _, ref_w = _run_jax("tcs_mixed_ref", LR)
    broker = SocketMqttBroker(port=0)
    try:
        kw = dict(LR, mqtt_socket=broker.address, object_store_dir=str(tmp_path / "store"))
        jfed = Federation(fedml_tpu, "tcs_mixed", kw, backend="MQTT_S3", roles={1: None, 2: None})
        tfed = Federation(fedml_tpu_torch, "tcs_mixed", kw, backend="MQTT_S3", roles={0: None})
        assert sorted(jfed.runners) == [0] and sorted(tfed.runners) == [1, 2]
        clients = [threading.Thread(target=tfed._party, args=(r,), daemon=True, name=f"port-{r}")
                   for r in tfed.runners]
        jfed.run(others=clients)
        assert not tfed.errors, tfed.errors
    finally:
        broker.stop()
    assert jfed.server.final_metrics["round"] == 1
    got = jax.device_get(_global(jfed))
    assert _max_err_of_scale(got, ref_w) <= 1e-5


@pytest.mark.parametrize("knob", [None, "fleet_trace", "quorum_frac"])
def test_fleet_view_is_fed_only_under_a_knob_that_reads_it(knob, tmp_path):
    """Without a resilience knob the server leaves the clients' telemetry
    deltas unmerged (no health round, no expected cohort): the round runs as
    it did before the fleet view. A knob that reads the fleet feeds it."""
    over = {None: {}, "fleet_trace": dict(fleet_trace=str(tmp_path / "f.json")),
            "quorum_frac": dict(quorum_frac=0.5)}[knob]
    fed, hist, _ = _run_port(f"tcs_fleet_{knob}", dict(LR, **over))
    fleet = fed.server.aggregator.fleet
    assert [m["round"] for m in hist] == [0, 1]
    if knob is None:
        assert fleet.merges == 0 and fleet.expected_ranks is None
        assert fleet.health.report() is None
    else:
        assert fleet.merges == 2 * LR["comm_round"] and fleet.ranks == [1, 2]
        assert fleet.health.report() is not None
    assert (tmp_path / "f.json").exists() == (knob == "fleet_trace")


def test_no_payload_aliases_a_module_and_the_global_stays_put():
    """INMEMORY hands state dicts over by reference. After a round: no
    client's upload shares storage with its module's parameters, and the
    global the server broadcast (each client holds it by reference) is bit
    for bit what the fold made, after the clients' next local training."""
    InMemoryBroker.reset("tcs_alias")
    fed = Federation(fedml_tpu_torch, "tcs_alias", LR)
    agg = fed.server.aggregator
    uploads, globals_ = [], []
    add, aggregate = agg.add_local_trained_result, agg.aggregate

    def record_add(index, params, n):
        uploads.append((index, params))
        add(index, params, n)

    def record_aggregate():
        out = aggregate()
        globals_.append((out, {k: v.clone() for k, v in out.items()}))
        return out

    agg.add_local_trained_result, agg.aggregate = record_add, record_aggregate
    fed.run()
    InMemoryBroker.reset("tcs_alias")
    assert len(uploads) == 4 and len(globals_) == 2
    ptrs = {r: {p.untyped_storage().data_ptr()
                for p in fed.client_trainer(r).model.module.parameters()} for r in (1, 2)}
    for index, params in uploads:
        assert not {v.untyped_storage().data_ptr() for v in params.values()} & ptrs[index + 1]
    round0, frozen = globals_[0]  # broadcast for round 1, trained from by both clients
    assert all(torch.equal(round0[k], frozen[k]) for k in frozen)
    assert any(not torch.equal(round0[k], globals_[1][0][k]) for k in frozen)


def test_cross_silo_spans_per_role():
    """The server's round spans and the clients' train spans, read per
    thread: one server.round, server.aggregate and server.eval per round, a
    server.broadcast per round after the first, and one client.train per
    client and round on that client's own thread."""
    since = max((r["seq"] for r in tel.snapshot()["spans"]), default=0)
    _run_port("tcs_spans", LR)
    spans = [r for r in tel.snapshot()["spans"] if r["seq"] > since]
    by_name = {}
    for r in spans:
        by_name.setdefault(r["name"], []).append(r)
    for name, n in (("server.round", 2), ("server.aggregate", 2), ("server.eval", 2),
                    ("server.broadcast", 1), ("server.receive_model", 4),
                    ("client.train", 4), ("client.upload", 4)):
        assert len(by_name.get(name, [])) == n, (name, len(by_name.get(name, [])))
    server_tids = {r["tid"] for r in by_name["server.aggregate"]}
    train_tids = {r["tid"] for r in by_name["client.train"]}
    assert len(server_tids) == 1 and len(train_tids) == 2 and not server_tids & train_tids
    # the clients' spans carry the server's round trace
    assert {r.get("trace_round") for r in by_name["client.train"]} == {0, 1}


def test_arrivals_take_the_globals_key_order():
    """The fold flattens each state dict in its own key order, and a wire
    arrival comes in flax's (by name): the aggregator puts it in the
    global's order at ingest, values untouched, and refuses an arrival with
    other parameters."""
    InMemoryBroker.reset("tcs_order")
    fed = Federation(fedml_tpu_torch, "tcs_order", LR)
    agg = fed.server.aggregator
    ref = agg.get_global_model_params()
    arrival = {k: v.clone() + 1.0 for k, v in reversed(list(ref.items()))}
    agg.add_local_trained_result(0, arrival, 10)
    got = agg.model_dict[0]
    assert list(got) == list(ref) != list(arrival)
    assert all(torch.equal(got[k], arrival[k]) for k in ref)
    with pytest.raises(ValueError, match="other parameters"):
        agg.add_local_trained_result(1, {"linear.weight": ref["linear.weight"]}, 10)
    InMemoryBroker.reset("tcs_order")


# --- async rounds ---------------------------------------------------------------

ASYNC = dict(LR, async_rounds=True, async_publish_k=3, comm_round=3, async_staleness_exponent=0.5,
             async_max_staleness=1)


class Turnstile:
    """Puts a federation's uploads in one order: client ``r`` of ``n``
    sends its ``k``-th upload on turn ``k * n + r - 1``, and a turn ends
    when the server has handled the upload (and sent its reply: a client
    may be back before the turn has ended). Once the server has published
    its last model the turnstile opens."""

    def __init__(self, n_clients):
        self.n = int(n_clients)
        self.seq, self.open, self.sent = 0, False, {}
        self.cv = threading.Condition()

    def wrap_client(self, rank, cm):
        send = cm.send_model_to_server

        def in_turn(receive_id, weights, n):
            with self.cv:
                turn = self.sent.get(rank, 0) * self.n + rank - 1
                assert self.cv.wait_for(lambda: self.open or self.seq == turn, timeout=JOIN_S)
                self.sent[rank] = self.sent.get(rank, 0) + 1
            send(receive_id, weights, n)
        cm.send_model_to_server = in_turn

    def wrap_client_sends(self, rank, cm):
        """Gate the client's model MESSAGES instead of its
        ``send_model_to_server`` calls: under secagg an upload may be queued
        for the window's key directory and sent later from the directory's
        handler, so only the send itself is one turn."""
        send = cm.send_message
        model_type = MODEL_TO_SERVER

        def in_turn(message):
            if message.get_type() == model_type:
                with self.cv:
                    turn = self.sent.get(rank, 0) * self.n + rank - 1
                    assert self.cv.wait_for(lambda: self.open or self.seq == turn,
                                            timeout=JOIN_S)
                    self.sent[rank] = self.sent.get(rank, 0) + 1
            send(message)
        cm.send_message = in_turn

    def wrap_server(self, server):
        handle = server.handle_message_receive_model_from_client

        def then_advance(msg):
            handle(msg)
            with self.cv:
                self.seq += 1
                self.open = server.args.round_idx >= server.round_num
                self.cv.notify_all()
        server.handle_message_receive_model_from_client = then_advance


def _record_async(server, to_np):
    """Every arrival's (rank, client version, verdict) and every publish."""
    buf, agg = server.aggregator.async_buffer, server.aggregator
    arrivals, publishes = [], []
    submit, publish = buf.submit, agg.publish_async

    def rec_submit(rank, tree, n, client_version):
        verdict = submit(rank, tree, n, client_version)
        arrivals.append((int(rank), client_version, verdict))
        return verdict

    def rec_publish():
        out = publish()
        if out is not None:
            publishes.append(to_np(out))
        return out

    buf.submit, agg.publish_async = rec_submit, rec_publish
    return arrivals, publishes


def _async_fed(pkg, run_id, kw, backend="INMEMORY", roles=None, prepare=None, turnstile=None):
    fed = Federation(pkg, run_id, kw, backend=backend, roles=roles, prepare=prepare)
    turn = turnstile or Turnstile(kw["client_num_per_round"])
    for rank, runner in fed.runners.items():
        if rank == 0:
            turn.wrap_server(fed.server)
        elif kw.get("privacy"):
            turn.wrap_client_sends(rank, runner.runner.client_manager)
        else:
            turn.wrap_client(rank, runner.runner.client_manager)
    return fed, turn


def _port_np(tree):
    return params_to_jax({k: v.detach().clone() for k, v in tree.items()})


def test_async_rounds_track_jax_publish_by_publish():
    p0 = _jax_p0(ASYNC)
    JBroker.reset("tcs_async_jax")
    jfed, _ = _async_fed(fedml_tpu, "tcs_async_jax", ASYNC)
    jhist = _record_evals(jfed)
    jarr, jpub = _record_async(jfed.server, jax.device_get)
    jfed.run()
    JBroker.reset("tcs_async_jax")
    InMemoryBroker.reset("tcs_async_port")
    fed, _ = _async_fed(fedml_tpu_torch, "tcs_async_port", ASYNC, prepare=_from_jax_params(p0))
    hist = _record_evals(fed)
    arr, pub = _record_async(fed.server, _port_np)
    fed.run()
    InMemoryBroker.reset("tcs_async_port")
    assert arr == jarr and len(arr) >= 9
    assert {v for _, _, v in arr} >= {"accept", "stale_accepted"}
    assert len(pub) == len(jpub) == 3 and fed.server.aggregator.async_buffer.version == 3
    for got, ref in zip(pub, jpub):
        assert _max_err_of_scale(got, ref) <= 1e-5
    assert [m["round"] for m in hist] == [m["round"] for m in jhist] == [0, 1, 2]
    for g, r in zip(hist, jhist):
        assert g["test_total"] == r["test_total"]
        np.testing.assert_allclose(g["test_loss"], r["test_loss"], rtol=1e-5)
    assert fed.server.final_metrics == hist[-1]
    assert _max_err_of_scale(_port_np(_global(fed)), jax.device_get(_global(jfed))) <= 1e-5


def test_async_jax_server_with_port_clients_over_the_socket_broker(tmp_path):
    """A JAX async server and two port clients over a JAX SocketMqttBroker,
    in the turnstile's order: the same arrivals as the all-JAX async run
    over INMEMORY, and final params within 1e-5 of its."""
    JBroker.reset("tcs_async_mixed_ref")
    rfed, _ = _async_fed(fedml_tpu, "tcs_async_mixed_ref", ASYNC)
    rarr, _ = _record_async(rfed.server, jax.device_get)
    rfed.run()
    JBroker.reset("tcs_async_mixed_ref")
    broker = SocketMqttBroker(port=0)
    try:
        kw = dict(ASYNC, mqtt_socket=broker.address, object_store_dir=str(tmp_path / "store"))
        jfed, turn = _async_fed(fedml_tpu, "tcs_async_mixed", kw, backend="MQTT_S3",
                                roles={1: None, 2: None})
        tfed, _ = _async_fed(fedml_tpu_torch, "tcs_async_mixed", kw, backend="MQTT_S3",
                             roles={0: None}, turnstile=turn)
        arr, _ = _record_async(jfed.server, jax.device_get)
        clients = [threading.Thread(target=tfed._party, args=(r,), daemon=True, name=f"port-{r}")
                   for r in tfed.runners]
        jfed.run(others=clients)
        assert not tfed.errors, tfed.errors
    finally:
        broker.stop()
    assert arr == rarr and jfed.server.aggregator.async_buffer.version == 3
    assert _max_err_of_scale(jax.device_get(_global(jfed)), jax.device_get(_global(rfed))) <= 1e-5


def test_async_port_server_with_jax_clients_over_the_socket_broker(tmp_path):
    """The other way round: a port async server and two JAX clients over a
    JAX SocketMqttBroker, in the turnstile's order, from the JAX initial
    params: the same arrivals as the all-JAX async run over INMEMORY, and
    final params within 1e-5 of its."""
    p0 = _jax_p0(ASYNC)
    JBroker.reset("tcs_async_rmixed_ref")
    rfed, _ = _async_fed(fedml_tpu, "tcs_async_rmixed_ref", ASYNC)
    rarr, _ = _record_async(rfed.server, jax.device_get)
    rfed.run()
    JBroker.reset("tcs_async_rmixed_ref")
    broker = SocketMqttBroker(port=0)
    try:
        kw = dict(ASYNC, mqtt_socket=broker.address, object_store_dir=str(tmp_path / "store"))
        tfed, turn = _async_fed(fedml_tpu_torch, "tcs_async_rmixed", kw, backend="MQTT_S3",
                                roles={1: None, 2: None}, prepare=_from_jax_params(p0))
        jfed, _ = _async_fed(fedml_tpu, "tcs_async_rmixed", kw, backend="MQTT_S3",
                             roles={0: None}, turnstile=turn)
        arr, _ = _record_async(tfed.server, _port_np)
        clients = [threading.Thread(target=jfed._party, args=(r,), daemon=True, name=f"jax-{r}")
                   for r in jfed.runners]
        tfed.run(others=clients)
        assert not jfed.errors, jfed.errors
    finally:
        broker.stop()
    assert arr == rarr and tfed.server.aggregator.async_buffer.version == 3
    assert _max_err_of_scale(_port_np(_global(tfed)), jax.device_get(_global(rfed))) <= 1e-5


# --- the uplink compressor -----------------------------------------------------------

def test_comm_compressor_full_ratio_uplink_parity():
    """tests/test_cross_silo.py's case in the port: at eftopk ratio 1.0 the
    uplink round-trips bit-exactly, so the compressed run's metrics and
    final params equal the uncompressed run's; every upload went through
    client.compress and server.decompress."""
    _, plain_hist, plain_w = _run_port("tcs_comp_off", LR)
    since = max((r["seq"] for r in tel.snapshot()["spans"]), default=0)
    _, hist, w = _run_port("tcs_comp_on", dict(LR, comm_compressor="eftopk",
                                               comm_compressor_ratio=1.0))
    names = [r["name"] for r in tel.snapshot()["spans"] if r["seq"] > since]
    assert names.count("client.compress") == names.count("server.decompress") == 4
    assert hist == plain_hist
    assert list(w) == list(plain_w) and all(torch.equal(w[k], plain_w[k]) for k in w)


def test_comm_compressor_lossy_uplink_still_converges():
    """A sparsifying uplink (topk ratio 0.25) completes the run with finite
    metrics, the server decompressing each arrival."""
    fed, hist, w = _run_port("tcs_comp_lossy", dict(LR, comm_compressor="topk",
                                                    comm_compressor_ratio=0.25))
    assert [m["round"] for m in hist] == [0, 1] and np.isfinite(hist[-1]["test_loss"])
    assert all(torch.isfinite(v).all() for v in w.values())


# --- privacy: windowed async SecAgg and accounted DP ------------------------------

SECAGG = dict(LR, async_rounds=True, async_publish_k=2, comm_round=3,
              async_staleness_exponent=0.0, privacy="secagg")


def _record_publishes(server, to_np):
    publishes = []
    publish = server.aggregator.async_buffer.publish

    def rec():
        out = publish()
        if out is not None:
            publishes.append(to_np(out))
        return out

    server.aggregator.async_buffer.publish = rec
    return publishes


def _within_one_step(got, ref, step):
    g, r = _leaves(got), _leaves(ref)
    assert sorted(g) == sorted(r)
    return max(float(np.abs(_np(g[k]).astype(np.float64) - _np(r[k])).max()) for k in r) <= step


def test_async_secagg_federation_tracks_jax_publish_by_publish():
    """Masked windows on both sides, the model uploads in one order: the
    same number of windows and masked merges, every publish within one
    QuantSpec.step of JAX's at every coordinate."""
    p0 = _jax_p0(SECAGG)
    t = tel.get_telemetry()
    m0 = t.counter("secagg.masked_merges").value
    JBroker.reset("tcs_secagg_jax")
    jfed, _ = _async_fed(fedml_tpu, "tcs_secagg_jax", SECAGG)
    jpub = _record_publishes(jfed.server, jax.device_get)
    jfed.run()
    JBroker.reset("tcs_secagg_jax")
    InMemoryBroker.reset("tcs_secagg_port")
    fed, _ = _async_fed(fedml_tpu_torch, "tcs_secagg_port", SECAGG, prepare=_from_jax_params(p0))
    pub = _record_publishes(fed.server, _port_np)
    fed.run()
    InMemoryBroker.reset("tcs_secagg_port")
    co = fed.server.aggregator.secagg_coordinator
    step = co.spec.step
    assert co.windows_total == jfed.server.aggregator.secagg_coordinator.windows_total == 3
    assert t.counter("secagg.masked_merges").value - m0 == 6
    assert len(pub) == len(jpub) == 3 and fed.server.aggregator.async_buffer.version == 3
    for got, ref in zip(pub, jpub):
        assert _within_one_step(got, ref, step)
    assert _within_one_step(_port_np(_global(fed)), jax.device_get(_global(jfed)), step)


def test_async_jax_secagg_server_with_port_clients_over_the_socket_broker(tmp_path):
    """A JAX async secagg server and two port clients over a JAX
    SocketMqttBroker (masked payloads through the npz codec, the window's
    control messages as JSON), uploads in the turnstile's order: every
    publish within one step of the all-JAX run's."""
    JBroker.reset("tcs_secagg_mixed_ref")
    rfed, _ = _async_fed(fedml_tpu, "tcs_secagg_mixed_ref", SECAGG)
    rpub = _record_publishes(rfed.server, jax.device_get)
    rfed.run()
    JBroker.reset("tcs_secagg_mixed_ref")
    broker = SocketMqttBroker(port=0)
    try:
        kw = dict(SECAGG, mqtt_socket=broker.address, object_store_dir=str(tmp_path / "store"))
        jfed, turn = _async_fed(fedml_tpu, "tcs_secagg_mixed", kw, backend="MQTT_S3",
                                roles={1: None, 2: None})
        tfed, _ = _async_fed(fedml_tpu_torch, "tcs_secagg_mixed", kw, backend="MQTT_S3",
                             roles={0: None}, turnstile=turn)
        pub = _record_publishes(jfed.server, jax.device_get)
        clients = [threading.Thread(target=tfed._party, args=(r,), daemon=True, name=f"port-{r}")
                   for r in tfed.runners]
        jfed.run(others=clients)
        assert not tfed.errors, tfed.errors
    finally:
        broker.stop()
    step = jfed.server.aggregator.secagg_coordinator.spec.step
    assert len(pub) == len(rpub) == 3
    for got, ref in zip(pub, rpub):
        assert _within_one_step(got, ref, step)


def test_secagg_dropout_drill_closes_windows_partial():
    """tests/test_privacy.py's message-plane drill in the port: rank 3
    completes key exchange, then drops its masked upload; the deadline fires,
    the survivors reveal their shares of its key over the wire, and each
    window publishes partial: the run ends, no party hangs, and no window
    timer outlives it."""
    t = tel.get_telemetry()
    c0 = {c: t.counter(c).value for c in ("secagg.dropouts", "secagg.recovered",
                                          "quorum.partial")}
    kw = dict(LR, client_num_in_total=3, client_num_per_round=3, async_rounds=True,
              async_publish_k=3, async_staleness_exponent=0.0, privacy="secagg",
              secagg_window_deadline_s=3.0)
    InMemoryBroker.reset("tcs_secagg_drill")
    fed = Federation(fedml_tpu_torch, "tcs_secagg_drill", kw)
    cm3 = fed.runners[3].runner.client_manager
    cm3.args.chaos_secagg_drop_upload_at_round = 0
    fed.run()
    InMemoryBroker.reset("tcs_secagg_drill")
    server = fed.server
    assert np.isfinite(fed.results[0]["test_loss"]) and server.aggregator.async_buffer.version == 2
    assert t.counter("secagg.dropouts").value > c0["secagg.dropouts"]
    assert t.counter("secagg.recovered").value - c0["secagg.recovered"] == 2
    assert t.counter("quorum.partial").value - c0["quorum.partial"] == 2
    assert server._secagg_deadline_timer is None


def test_sync_dp_federation_clean_mean_tracks_jax():
    """A synchronous dp federation (LR, 2 clients, 2 rounds, a clip of 0.05
    that binds): each round's clipped mean before the noise within 1e-5 of
    its scale of JAX's. The port's run publishes JAX's realized noise
    (JAX's published model less its clean mean), so both runs train from the
    same models; the port's own draws of each round are kept, and pass the
    statistics test. Both accountants stepped twice, to the same epsilon."""
    kw = dict(LR, privacy="dp", dp_l2_clip=0.05, dp_noise_multiplier=0.5, dp_seed=3)
    p0 = _jax_p0(kw)

    def recording(agg, rows, swap=None):
        noise = agg.dp_fold.noise_tree

        def rec(tree, n):
            out = noise(tree, n)
            rows.append((tree, out, n))
            return swap(len(rows) - 1, tree, out) if swap is not None else out
        agg.dp_fold.noise_tree = rec

    JBroker.reset("tcs_dp_jax")
    jfed = Federation(fedml_tpu, "tcs_dp_jax", kw)
    jrows = []
    recording(jfed.server.aggregator, jrows)
    jfed.run()
    JBroker.reset("tcs_dp_jax")

    def jax_noise(i, clean, own):
        jclean, jout = (params_from_jax(jax.device_get(x)) for x in jrows[i][:2])
        return {k: (clean[k] + (jout[k] - jclean[k])) for k in clean}

    InMemoryBroker.reset("tcs_dp_port")
    fed = Federation(fedml_tpu_torch, "tcs_dp_port", kw, prepare=_from_jax_params(p0))
    rows = []
    recording(fed.server.aggregator, rows, swap=jax_noise)
    fed.run()
    InMemoryBroker.reset("tcs_dp_port")
    assert len(rows) == len(jrows) == 2
    draws = []
    for (clean, out, n), (jclean, _, jn) in zip(rows, jrows):
        assert n == jn == 2
        assert _max_err_of_scale(_port_np(clean), jax.device_get(jclean)) <= 1e-5
        draws.append(torch.cat([(out[k] - clean[k]).reshape(-1) for k in clean]).double())
    noise = torch.cat(draws).numpy()
    sigma = 0.5 * 0.05 / 2
    assert noise.size == 2 * 610
    assert abs(float(noise.std()) - sigma) <= 0.1 * sigma
    assert abs(float(noise.mean())) <= 4 * sigma / np.sqrt(noise.size)
    pacc = fed.server.aggregator.dp_fold.accountant
    jacc = jfed.server.aggregator.dp_fold.accountant
    assert pacc.steps == jacc.steps == 2
    assert abs(pacc.epsilon_spent - jacc.epsilon_spent) <= 1e-12


# --- what is not ported raises ---------------------------------------------------

GATES = {
    # the secure fronts run over INMEMORY only (ROADMAP.md, Queue 3, R4)
    "secure_aggregation_secagg": ("server", dict(secure_aggregation="secagg", backend="MQTT_S3")),
    "secure_aggregation_lsa": ("client", dict(secure_aggregation="lsa", backend="MQTT_S3")),
    "comm_compressor": ("client", dict(comm_compressor="eftopk", backend="MQTT_S3")),
    # JAX's compressed payload fails on every byte backend (ROADMAP.md, Queue 3, R6)
    **{f"comm_compressor_{b}": ("client", dict(comm_compressor="eftopk", backend=b))
       for b in ("TRPC", "GRPC", "MPI", "MQTT_WEB3", "MQTT_THETASTORE")},
    "server_mesh": ("server", dict(server_mesh="1x1")),
    "chaos_split_kill_rank": ("server", dict(chaos_split_kill_rank=1)),
    "mqtt_host": ("client", dict(backend="MQTT_S3", mqtt_host="broker.example")),
    "s3_bucket": ("server", dict(backend="MQTT_S3", s3_bucket="bucket")),
}

# knobs of the resilience, privacy and secure-aggregation slices: each party
# builds (tests/test_torch_resilience.py, the privacy tests above and
# tests/test_torch_secagg.py run them)
PORTED = {
    "privacy": ("server", dict(privacy="dp")),
    "privacy_client": ("client", dict(privacy="secagg")),
    "chaos_secagg_drop_upload_at_round": ("client", dict(chaos_secagg_drop_upload_at_round=0)),
    "async_checkpoint_every_merges": ("server", dict(async_rounds=True,
                                                     async_checkpoint_every_merges=4)),
    "quorum": ("server", dict(quorum_frac=0.5)),
    "round_deadline": ("server", dict(round_deadline_s=5.0)),
    "adaptive_deadline": ("server", dict(adaptive_deadline=True)),
    "overprovision": ("server", dict(overprovision_frac=0.5, client_num_connected=3)),
    "resilience_dir": ("server", dict(resilience_dir="rs", resume=True)),
    "fleet_trace": ("server", dict(fleet_trace="t.json")),
    "chaos_train_delay_s": ("client", dict(chaos_train_delay_s=1.0, chaos_train_delay_rounds=1)),
    "chaos_raise_at_round": ("client", dict(chaos_raise_at_round=0)),
    "chaos_nan_at_round": ("client", dict(chaos_nan_at_round=0)),
    "chaos_scale_delta": ("client", dict(chaos_scale_delta=2.0, chaos_scale_at_round=1)),
    "chaos_kill_after_round": ("server", dict(resilience_dir="rs", chaos_kill_after_round=1)),
    "chaos_kill_after_merges": ("server", dict(async_rounds=True, resilience_dir="rs",
                                               chaos_kill_after_merges=3)),
    # the round-barrier secure fronts, by each of their four names
    **{f"secure_aggregation_{name}_{role}": (role, dict(secure_aggregation=name))
       for name in ("secagg", "sa", "lightsecagg", "lsa") for role in ("server", "client")},
    # the link layer (tests/test_torch_netlink.py runs them)
    "async_link_admission": ("server", dict(async_rounds=True, async_link_admission=True)),
    "quorum_link_cost": ("server", dict(quorum_frac=0.5, quorum_link_cost=True)),
    "link_probe_interval_s": ("server", dict(link_probe_interval_s=1.0)),
    "link_wan_health": ("server", dict(link_wan_health=True)),
    "chaos_link_throttle": ("client", dict(chaos_link_throttle=1e6)),
    "chaos_link_base_delay_s": ("client", dict(chaos_link_base_delay_s=0.1)),
    # modelwatch's quarantine (tests/test_torch_modelwatch.py runs it)
    "modelwatch_quarantine": ("server", dict(modelwatch_quarantine=True)),
    # the message plane's other backends and the reference wire
    # (tests/test_torch_{trpc,grpc,web3,ref_wire}.py run them)
    "mqtt_s3_wire_fedml": ("server", dict(backend="MQTT_S3", mqtt_s3_wire="fedml",
                                          mqtt_s3_bucket_dir="bucket")),
    **{f"backend_{b}": ("server", dict(backend=b))
       for b in ("GRPC", "MPI", "TRPC", "MQTT_WEB3", "MQTT_THETASTORE")},
    # a silo of one process trains unsharded (test_hierarchical_silos_track_jax
    # runs silos of two)
    "scenario_hierarchical": ("client", dict(scenario="hierarchical")),
}


def _party_args(gate, over, role, tmp_path):
    kw = dict(LR, run_id=f"tcs_gate_{gate}", rank=0 if role == "server" else 1, role=role,
              backend="INMEMORY", using_gpu=False, object_store_dir=str(tmp_path),
              cas_root=str(tmp_path / "cas"))
    kw.update(over)
    if "resilience_dir" in kw:
        kw["resilience_dir"] = str(tmp_path / kw["resilience_dir"])
    if "mqtt_s3_bucket_dir" in kw:
        kw["mqtt_s3_bucket_dir"] = str(tmp_path / kw["mqtt_s3_bucket_dir"])
    if kw["backend"] in ("TRPC", "GRPC", "MPI"):  # the party's listener on a free port
        key = "trpc_base_port" if kw["backend"] == "TRPC" else "grpc_base_port"
        kw[key] = free_port_block(1) - kw["rank"] - _run_id_offset(kw["run_id"])
    if "fleet_trace" in kw:
        kw["fleet_trace"] = str(tmp_path / kw["fleet_trace"])
    args = fedml_tpu_torch.default_config("cross_silo", **kw)
    dataset, output_dim = fedml_tpu_torch.data.load(copy.copy(args))
    return args, dataset, fedml_tpu_torch.model.create(args, output_dim, device="cpu")


@pytest.mark.parametrize("gate", list(PORTED))
def test_ported_resilience_knobs_build(gate, tmp_path):
    role, over = PORTED[gate]
    args, dataset, model = _party_args(gate, over, role, tmp_path)
    runner = fedml_tpu_torch.FedMLRunner(args, torch.device("cpu"), dataset, model)
    assert runner.runner is not None
    manager = getattr(runner.runner, "server_manager", None) or runner.runner.client_manager
    manager.com_manager.stop_receive_message()  # releases a listener's port
    InMemoryBroker.reset(f"tcs_gate_{gate}")
    LocalMqttBroker.reset(args.run_id)


@pytest.mark.parametrize("gate", list(GATES))
def test_unported_knobs_and_backends_raise(gate, tmp_path):
    role, over = GATES[gate]
    args, dataset, model = _party_args(gate, over, role, tmp_path)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fedml_tpu_torch.FedMLRunner(args, torch.device("cpu"), dataset, model)
    LocalMqttBroker.reset(args.run_id)


# the server's telemetry front: statusz alone, with an slo_spec file, with an
# slo_tick_s ticker (each also an SLO engine ticked once a round)
STATUSZ_CASES = ("statusz", "slo", "slo_tick_s")
# /metrics families the server's own gauges and its SLO engine put there
SERVER_FAMILIES = ("fedml_client_", "fedml_dp_", "fedml_alert_", "fedml_slo_")
# modelwatch's contribution ledger on both servers
MODELWATCH_FAMILIES = {"fedml_client_delta_norm", "fedml_client_outlier_score",
                       "fedml_client_contribution"}


def _serve_statusz(pkg, case, tmp_path):
    """A dp federation (LR, 2 clients, 2 rounds) whose server serves
    /statusz; the pages are read during round 1's evaluation. The package's
    telemetry registry is on for the run (the clients ship the deltas that
    the health gauges read only then; a test elsewhere in the worker may
    have left it off), and restored after."""
    registry = importlib.import_module(f"{pkg.__name__}.core.telemetry").get_telemetry()
    was = registry.enabled
    registry.set_enabled(True)
    try:
        with _isolated_registry(registry):
            return _serve_statusz_run(pkg, case, tmp_path)
    finally:
        registry.set_enabled(was)


@contextlib.contextmanager
def _isolated_registry(registry):
    """The registry's counters and histograms set aside for the run (another
    test in the worker may have left entries of its own: JAX's
    tests/test_slo.py registers ``slo.test.*``), so /metrics shows only what
    the run registered; put back after it, over any entry of the same name."""
    with registry._lock:
        saved = dict(registry._counters), dict(registry._histograms)
        registry._counters.clear()
        registry._histograms.clear()
    try:
        yield
    finally:
        with registry._lock:
            registry._counters.update(saved[0])
            registry._histograms.update(saved[1])


def _serve_statusz_run(pkg, case, tmp_path):
    run_id = f"tcs_statusz_{case}_{pkg.__name__}"
    port_file = tmp_path / f"{pkg.__name__}.port"
    kw = dict(LR, privacy="dp", dp_l2_clip=0.05, dp_noise_multiplier=0.5, dp_seed=3,
              statusz_port=0, statusz_port_file=str(port_file))
    if case == "slo":
        spec = tmp_path / f"{pkg.__name__}_slo.json"
        spec.write_text(json.dumps({"replace": True, "slos": [
            {"name": "round_p99_seconds", "series": "engine.round_seconds",
             "signal": "quantile", "q": 0.99, "comparator": "<=", "target": 600.0}]}))
        kw["slo_spec"] = str(spec)
    if case == "slo_tick_s":
        kw["slo_tick_s"] = 0.02
    (JBroker if pkg is fedml_tpu else InMemoryBroker).reset(run_id)
    fed = Federation(pkg, run_id, kw)
    agg = fed.server.aggregator
    test = agg.test_on_server_for_all_clients
    pages = {}

    def probed(round_idx):
        if round_idx == 1:
            port = int(port_file.read_text())
            deadline = time.monotonic() + 10
            while True:  # a ticker ticks on its own, beside the per-round tick
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/statusz", timeout=10) as r:
                    doc = json.loads(r.read())
                ticks = doc["sections"]["alerts"]["tick_count"]
                if case != "slo_tick_s" or ticks >= 3 or time.monotonic() > deadline:
                    break
                time.sleep(0.02)
            pages["statusz"] = doc
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
                pages["metrics"] = r.read().decode()
        return test(round_idx)

    agg.test_on_server_for_all_clients = probed
    fed.run()
    (JBroker if pkg is fedml_tpu else InMemoryBroker).reset(run_id)
    return pages


def _families(text):
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ") and line.split()[2].startswith(SERVER_FAMILIES)}


@pytest.mark.parametrize("case", STATUSZ_CASES)
def test_server_statusz_metrics_and_slo_tick(case, tmp_path):
    """``statusz_port``, ``slo_spec`` and ``slo_tick_s`` on the cross-silo
    server, over INMEMORY, against JAX's server in the same federation: the
    server's sections (round, health, privacy) with JAX's keys, the SLO
    engine's alerts section with the same SLOs ticked at least once a round
    (and by the ticker under slo_tick_s), and the same /metrics families of
    the server's gauges (client health, the DP budget, modelwatch's
    contribution ledger) and its SLO engine."""
    got = {pkg: _serve_statusz(pkg, case, tmp_path) for pkg in (fedml_tpu, fedml_tpu_torch)}
    jdoc, tdoc = got[fedml_tpu]["statusz"], got[fedml_tpu_torch]["statusz"]
    assert tdoc["service"] == jdoc["service"] == "cross_silo_server"
    for name in ("round", "health", "privacy"):
        assert name in tdoc["sections"] and name in jdoc["sections"], name
        assert sorted(tdoc["sections"][name]) == sorted(jdoc["sections"][name]), name
    assert tdoc["sections"]["round"]["round_idx"] == jdoc["sections"]["round"]["round_idx"] == 1
    assert tdoc["sections"]["privacy"]["mode"] == jdoc["sections"]["privacy"]["mode"] == "dp"
    assert sorted(tdoc["sections"]["privacy"]["dp"]) == sorted(jdoc["sections"]["privacy"]["dp"])
    assert tdoc["sections"]["privacy"]["dp"]["steps"] == jdoc["sections"]["privacy"]["dp"]["steps"]
    talerts, jalerts = tdoc["sections"]["alerts"], jdoc["sections"]["alerts"]
    assert talerts["front"] == jalerts["front"] == "cross_silo"
    assert sorted(talerts["slos"]) == sorted(jalerts["slos"])
    if case == "slo":
        assert sorted(talerts["slos"]) == ["round_p99_seconds"]
    assert talerts["tick_count"] >= (3 if case == "slo_tick_s" else 1)
    assert jalerts["tick_count"] >= (3 if case == "slo_tick_s" else 1)
    tfam, jfam = _families(got[fedml_tpu_torch]["metrics"]), _families(got[fedml_tpu]["metrics"])
    assert tfam == jfam
    assert MODELWATCH_FAMILIES <= tfam
    assert {"fedml_dp_epsilon_spent", "fedml_dp_budget_frac", "fedml_client_health",
            "fedml_alert_active"} <= tfam
