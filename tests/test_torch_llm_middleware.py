"""The FedLLM client's hooks and its train loop's telemetry and saves, in the
port against the JAX package, on the CPU.

- Local DP on the adapters (``enable_dp`` with ``ldp``, ``nbafl``,
  ``dp_clip``): both clients get the same incoming adapters A and the same
  "trained" adapters B (installed with ``set_model_params`` in place of the
  local steps, so the hooks alone are compared), then ``on_after_local_
  training``. DP-Clip's upload, A + clip(B - A), within 1e-6 of its scale
  of JAX's (the norm summed in other orders); the noise of ldp and nbafl
  (no PRNG matches across frameworks) held to ``tests/test_torch_dp.py``'s
  band: std within 4 / sqrt(2 n) of the frame's sigma, mean within
  4 sigma / sqrt(n), on both sides, with equal sigmas. A whole local round
  of each (hooks, steps, hooks) runs on the port's client too.
- R14 and R15 (ROADMAP.md, Queue 3): JAX's client fails with FHE
  (``AttributeError`` on the ``Ciphertext`` leaves) and with a data-poisoning
  attack (``TypeError`` unpacking its data), each shown beside the port's
  ``ValueError`` before the first local step. Model attacks pass the client
  untouched on both sides.
- ``LLMTrainer.train``: with ``save_steps=1`` every mid-training save is
  enqueued with ``wait=False`` and, each once written, bit-equal to a
  synchronous run's file of that step; all are on disk when ``train``
  returns; the ``llm.train`` span and the ``llm.tokens_per_sec`` histogram
  record the window.
- A 2-silo INMEMORY federation through ``FedMLRunner`` under ``dp_clip``,
  the server holding the adapters in an adapter-aware ``ServerAggregator``
  (JAX ``cross_cloud/__init__.py:10-15``): each fold within 1e-6 of its
  scale of the float64 sample-weighted mean of the uploads as received,
  each upload within the clip of the round's global, the published model
  the fold plus noise in the band above, the silos' base weights unchanged
  bit for bit; again with the server's accounted DP (``privacy: dp``) on
  top, whose clips run on the adapter trees the clients exchange.
"""

from __future__ import annotations

import math
import os
import threading
import types

import jax
import numpy as np
import pytest
import torch

import fedml_tpu_torch
from fedml_tpu.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy as JDP
from fedml_tpu.core.fhe.fhe_agg import FedMLFHE as JFHE
from fedml_tpu.core.security.fedml_attacker import FedMLAttacker as JAtk
from fedml_tpu.data.dataset import ArrayDataset as JArrayDataset
from fedml_tpu.train.llm.fed_llm_trainer import LLMClientTrainer as JClient
from fedml_tpu_torch.core import telemetry as tel
from fedml_tpu_torch.core.alg_frame.server_aggregator import ServerAggregator
from fedml_tpu_torch.core.distributed.communication.inmemory.broker import InMemoryBroker
from fedml_tpu_torch.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy as TDP
from fedml_tpu_torch.core.fhe.fhe_agg import FedMLFHE as TFHE
from fedml_tpu_torch.core.security.fedml_attacker import MODEL_ATTACKS
from fedml_tpu_torch.core.security.fedml_attacker import FedMLAttacker as TAtk
from fedml_tpu_torch.models.convert import params_from_jax, params_to_jax
from fedml_tpu_torch.train.llm import configurations as tc
from fedml_tpu_torch.train.llm import llm_trainer as tlt
from fedml_tpu_torch.train.llm.fed_llm_trainer import LLMClientTrainer as TClient
from fedml_tpu_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_dp import assert_draws

MODEL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
             seq_len=32, lora_rank=4, remat=False, attention_impl="xla")
DP = dict(enable_dp=True, mechanism_type="gaussian", epsilon=1.0, delta=1e-5, sensitivity=1.0,
          clipping_norm=0.5, noise_multiplier=1.0, random_seed=0, comm_round=2,
          client_num_per_round=2, client_num_in_total=2)
JOIN_S = 120


def _args(tmp_path, name, **over):
    return types.SimpleNamespace(**{**MODEL, "per_device_batch_size": 2, "local_steps": 2,
                                    "learning_rate": 1e-2, "warmup_steps": 1,
                                    "output_dir": str(tmp_path / name), **over})


def _reset_middleware():
    off = types.SimpleNamespace()
    for facade in (JDP, JAtk, JFHE, TDP, TAtk, TFHE):
        facade.get_instance().init(off)


@pytest.fixture(autouse=True)
def middleware_off():
    _reset_middleware()
    yield
    _reset_middleware()


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, prefix + (k,)) if isinstance(v, dict) else
                   {prefix + (k,): np.asarray(v, np.float64)})
    return out


def _flat(tree):
    leaves = _leaves(tree)
    return np.concatenate([leaves[p].ravel() for p in sorted(leaves)])


def _adapters_pair(seed):
    """Two adapter trees in JAX split_lora's layout: the round's incoming
    A and the "trained" B = A + a step of size about 0.05 a coordinate."""
    from fedml_tpu.models.lora import split_lora

    client = TClient(types.SimpleNamespace(**{**MODEL, "output_dir": "unused"}), device="cpu")
    shapes = {p: v.shape for p, v in _leaves(client.get_model_params()).items()}
    del client
    rng = np.random.default_rng(seed)

    def tree(scale):
        out = {}
        for path, shape in shapes.items():
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = rng.normal(0, scale, shape).astype(np.float32)
        return out

    a = tree(0.1)
    b = jax.tree.map(lambda x, d: (x + d).astype(np.float32), a, tree(0.05))
    assert split_lora  # the layout both clients exchange
    return a, b


def _hooks(client, a, b, args, train_data=None):
    """The hook sandwich with B installed in place of the local steps."""
    client.set_model_params(a)
    data = client.on_before_local_training(train_data, None, args)
    client.set_model_params(b)
    client.on_after_local_training(data, None, args)
    return client.get_model_params()


@pytest.fixture(scope="module")
def pair():
    return _adapters_pair(0)


@pytest.fixture(scope="module")
def jclient(tmp_path_factory):
    return JClient(_args(tmp_path_factory.mktemp("j"), "jax"))


@pytest.fixture(scope="module")
def tclient(tmp_path_factory):
    return TClient(_args(tmp_path_factory.mktemp("t"), "torch"), device="cpu")


def test_dp_clip_on_the_adapters_is_jax_s_clip(pair, jclient, tclient, tmp_path):
    a, b = pair
    args = _args(tmp_path, "x", **DP, dp_solution_type="dp_clip")
    JDP.get_instance().init(args)
    TDP.get_instance().init(args)
    for c in (jclient, tclient):
        c.local_sample_number = 5
    want = _flat(jax.device_get(_hooks(jclient, a, b, args)))
    got = _flat(_hooks(tclient, a, b, args))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    delta = got - _flat(a)
    assert np.linalg.norm(delta) == pytest.approx(0.5, rel=1e-6)  # B - A lay outside the ball
    # within the ball the upload is B itself
    b_small = jax.tree.map(lambda x, y: (x + (y - x) * 1e-3).astype(np.float32), a, b)
    assert np.array_equal(_flat(_hooks(tclient, a, b_small, args)), _flat(b_small))


@pytest.mark.parametrize("solution", ["ldp", "nbafl"])
def test_local_noise_on_the_adapters_follows_jax(solution, pair, jclient, tclient, tmp_path):
    a, b = pair
    args = _args(tmp_path, "x", **DP, dp_solution_type=solution)
    jdp, tdp = JDP.get_instance(), TDP.get_instance()
    jdp.init(args)
    tdp.init(args)
    for c in (jclient, tclient):
        c.local_sample_number = 5
    flat_b = _flat(b)
    if solution == "ldp":
        sigmas = (jdp.frame.ldp.sigma, tdp.frame.ldp.sigma)
        base = flat_b  # no max_grad_norm: LDP adds noise to the model as it is
    else:
        sigmas = (jdp.frame._sigma_u(5), tdp.frame._sigma_u(5))
        c = tdp.frame.big_c
        base = flat_b / np.maximum(np.abs(flat_b) / c, 1.0)
    assert sigmas[0] == sigmas[1] > 0
    for client in (jclient, tclient):
        out = _flat(jax.device_get(_hooks(client, a, b, args)))
        assert_draws(out - base, sigmas[1])


@pytest.mark.parametrize("solution", ["ldp", "nbafl", "dp_clip"])
def test_a_whole_local_round_under_local_dp(solution, tmp_path):
    """Hooks, two local steps, hooks, as a front runs them: finite adapters
    in JAX's paths, the base untouched; under dp_clip the upload within the
    clip of the incoming adapters."""
    args = _args(tmp_path, "c", **DP, dp_solution_type=solution)
    fedml_tpu_torch.init(args)
    client = TClient(args, device="cpu")
    client.set_id(0)
    client.update_dataset(None, None, 5)
    a = client.get_model_params()
    base = {n: p.detach().clone() for n, p in client.llm.model.named_parameters()
            if not tlt.is_lora_name(n)}
    blocks = np.random.default_rng(1).integers(0, 256, (5, 32)).astype(np.int32)
    data = client.on_before_local_training(blocks, None, args)
    metrics = client.train(data, None, args)
    client.on_after_local_training(data, None, args)
    out = client.get_model_params()
    assert metrics["steps"] == 2 and sorted(_leaves(out)) == sorted(_leaves(a))
    assert np.isfinite(_flat(out)).all() and not np.array_equal(_flat(out), _flat(a))
    if solution == "dp_clip":
        assert np.linalg.norm(_flat(out) - _flat(a)) <= 0.5 * (1 + 1e-6)
    for n, p in client.llm.model.named_parameters():
        if n in base:
            assert torch.equal(p, base[n]), n


def test_r14_fhe_on_the_fedllm_client(pair, jclient, tclient, tmp_path):
    """JAX's client merges the ciphertexts into its model and fails after
    the round; the port refuses before the first local step."""
    a, b = pair
    args = _args(tmp_path, "x", enable_fhe=True, fhe_scheme="rlwe")
    JFHE.get_instance().init(args)
    with pytest.raises(AttributeError, match="Ciphertext"):
        _hooks(jclient, a, b, args)
    for refused in (args, types.SimpleNamespace(**{**vars(args), "enable_fhe": False})):
        TFHE.get_instance().init(args, device="cpu")  # the singleton alone is enough, too
        with pytest.raises(ValueError, match="R14"):
            tclient.on_before_local_training(None, None, refused)
    with pytest.raises(ValueError, match="R14"):
        tclient.on_after_local_training(None, None, args)


@pytest.mark.parametrize("attack", ["label_flipping", "edge_case_backdoor"])
def test_r15_data_poisoning_on_the_fedllm_client(attack, jclient, tclient, tmp_path):
    """JAX's poisoning unpacks the client's dataset as a pair; the port
    refuses before the first local step (a causal LM reads no labels)."""
    args = _args(tmp_path, "x", enable_attack=True, attack_type=attack, poison_ratio=1.0,
                 original_class_list=[0], target_class_list=[1], ratio_of_poisoned_client=1.0,
                 client_num_in_total=2, comm_round=2)
    JAtk.get_instance().init(args)
    TAtk.get_instance().init(args)
    blocks = np.random.default_rng(2).integers(0, 256, (4, 32)).astype(np.int32)
    with pytest.raises(TypeError, match="unpack"):
        jclient.on_before_local_training(JArrayDataset(blocks, blocks), None, args)
    with pytest.raises(ValueError, match="R15"):
        tclient.on_before_local_training(blocks, None, args)


@pytest.mark.parametrize("attack", sorted(MODEL_ATTACKS))
def test_model_attacks_pass_the_client_untouched(attack, pair, jclient, tclient, tmp_path):
    a, b = pair
    args = _args(tmp_path, "x", enable_attack=True, attack_type=attack, byzantine_client_num=1,
                 attack_mode="random", client_num_in_total=2, comm_round=2)
    JAtk.get_instance().init(args)
    TAtk.get_instance().init(args)
    blocks = np.zeros((2, 32), np.int32)
    assert jclient.on_before_local_training(blocks, None, args) is blocks
    assert tclient.on_before_local_training(blocks, None, args) is blocks
    for client in (jclient, tclient):
        assert np.array_equal(_flat(jax.device_get(_hooks(client, a, b, args))), _flat(b))


# --- the train loop ---------------------------------------------------------

def _trainer(tmp_path, name, **exp):
    return tlt.LLMTrainer(tc.ModelArguments(**MODEL), tc.DatasetArguments(),
                          tc.ExperimentArguments(output_dir=str(tmp_path / name), **exp),
                          device="cpu")


def test_async_mid_training_saves_equal_sync_saves(tmp_path):
    """save_steps=1: each mid-training save is enqueued with wait=False and
    its file, once written, loads bit-equal to the synchronous run's; every
    step is on disk when train returns. The next step waits for the write in
    flight, so no enqueue is dropped and every step is checked."""
    exp = dict(max_steps=4, per_device_batch_size=2, learning_rate=1e-2, warmup_steps=1,
               save_steps=1)
    runs = {}
    for mode in ("async", "sync"):
        tr = _trainer(tmp_path, mode, **exp)
        tr.ckpt = CheckpointManager(str(tmp_path / mode), max_to_keep=100)
        tr._build(tr.init_params(seed=0))
        calls = []
        save = tr.ckpt.save

        def spy(step, tree, *, wait=True, _save=save, _calls=calls, _mode=mode):
            _calls.append((step, wait))
            return _save(step, tree, wait=wait if _mode == "async" else True)

        tr.ckpt.save = spy
        step_fn = tr._step_fn

        def step(*a, _fn=step_fn, _tr=tr):
            _tr.ckpt.wait_until_finished()
            return _fn(*a)

        tr._step_fn = step
        tr.train(tlt.synthetic_token_batches(256, 32, 2, 4, seed=0))
        runs[mode] = (tr, calls)
    tr, calls = runs["async"]
    assert calls == [(1, False), (2, False), (3, False), (4, False), (4, True)]
    assert tr.ckpt.latest_complete_step() == 4
    assert not (tr.ckpt._async_thread and tr.ckpt._async_thread.is_alive())
    for step in range(1, 5):
        got = torch.load(os.path.join(tmp_path, "async", f"step_{step}.pt"), weights_only=True)
        want = torch.load(os.path.join(tmp_path, "sync", f"step_{step}.pt"), weights_only=True)
        g, w = _leaves(_np_tree(got)), _leaves(_np_tree(want))
        assert g.keys() == w.keys()
        assert all(np.array_equal(g[p], w[p]) for p in w), step


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else v.float().numpy() for k, v in tree.items()}


def test_train_returns_with_every_save_on_disk(tmp_path):
    """The final save and any mid-training save still in flight are written
    and watermarked before train returns."""
    tr = _trainer(tmp_path, "t", max_steps=3, per_device_batch_size=2, save_steps=2)
    tr._build(tr.init_params(seed=0))
    tr.train()
    assert tr.ckpt.all_steps() == [2, 3] and tr.ckpt.latest_complete_step() == 3
    assert not (tr.ckpt._async_thread and tr.ckpt._async_thread.is_alive())


def test_train_records_its_span_and_tokens_per_sec(tmp_path):
    t = tel.get_telemetry()
    was = t.enabled
    t.set_enabled(True)
    try:
        before = t.summary()
        n0 = before["span_stats"].get("llm.train", {}).get("count", 0)
        h0 = before["histograms"].get("llm.tokens_per_sec", {}).get("count", 0)
        tr = _trainer(tmp_path, "t", max_steps=2, per_device_batch_size=2)
        metrics = tr.train()
        after = t.summary()
        assert after["span_stats"]["llm.train"]["count"] == n0 + 1
        hist = after["histograms"]["llm.tokens_per_sec"]
        assert hist["count"] == h0 + 1 and hist["last"] == metrics["tokens_per_sec"] > 0
    finally:
        t.set_enabled(was)


# --- a FedLLM federation ------------------------------------------------------

class AdapterAggregator(ServerAggregator):
    """The server side of a FedLLM federation: it holds the adapters
    (nested numpy, the layout the clients exchange), folds the uploads as
    state dicts, and records each round's uploads, fold and published
    model."""

    def __init__(self, adapters, args):
        super().__init__(None, args)
        self.adapters = adapters
        self.uploads, self.folds, self.published = [], [], []

    def get_model_params(self):
        return self.adapters

    def set_model_params(self, model_parameters) -> None:
        if not any(isinstance(v, dict) for v in model_parameters.values()):
            self.published.append({k: v.clone() for k, v in model_parameters.items()})
            model_parameters = params_to_jax(model_parameters)
        self.adapters = model_parameters

    def on_before_aggregation(self, raw):
        self.uploads.append([(n, jax.tree.map(np.array, m)) for n, m in raw])
        return super().on_before_aggregation([(n, params_from_jax(m)) for n, m in raw])

    def aggregate(self, raw):
        out = super().aggregate(raw)
        self.folds.append({k: v.clone() for k, v in out.items()})
        return out

    def test(self, test_data, device, args):
        return {"adapter_norm": float(np.linalg.norm(_flat(self.adapters)))}


def _run_federation(tmp_path, run_id, over):
    InMemoryBroker.reset(run_id)
    n = 2
    blocks = {i: np.random.default_rng(10 + i).integers(0, 256, (5 + 2 * i, 32)).astype(np.int32)
              for i in range(n)}
    dataset = [sum(len(b) for b in blocks.values()), 0, None, None,
               {i: len(b) for i, b in blocks.items()}, blocks, {i: None for i in blocks}, 0]
    runners, clients, errors = {}, {}, {}
    server_agg = None
    for rank in range(n + 1):
        role = "server" if rank == 0 else "client"
        args = fedml_tpu_torch.default_config(
            "cross_silo", run_id=run_id, rank=rank, role=role, backend="INMEMORY",
            client_num_in_total=n, client_num_per_round=n, comm_round=2, using_gpu=False,
            frequency_of_the_test=1, random_seed=0,
            **{**MODEL, "per_device_batch_size": 2, "local_steps": 2, "learning_rate": 1e-2,
               "warmup_steps": 1, "output_dir": str(tmp_path / f"silo{rank}")}, **over)
        args = fedml_tpu_torch.init(args)
        dev = torch.device("cpu")
        if rank == 0:
            start = TClient(args, device="cpu").get_model_params()
            server_agg = AdapterAggregator(start, args)
            runners[rank] = fedml_tpu_torch.FedMLRunner(args, dev, dataset, None,
                                                        server_aggregator=server_agg)
        else:
            clients[rank] = TClient(args, device="cpu")
            runners[rank] = fedml_tpu_torch.FedMLRunner(args, dev, dataset, None,
                                                        client_trainer=clients[rank])
    base0 = {r: {n: p.detach().clone() for n, p in c.llm.model.named_parameters()
                 if not tlt.is_lora_name(n)} for r, c in clients.items()}
    start = server_agg.get_model_params()

    def party(rank):
        try:
            runners[rank].run()
        except BaseException as e:  # reported below; the thread must not hang the test
            errors[rank] = e
            raise

    threads = [threading.Thread(target=party, args=(r,), daemon=True) for r in runners]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
        assert not t.is_alive(), "a party of the FedLLM federation is still running"
    assert not errors, errors
    InMemoryBroker.reset(run_id)
    return server_agg, clients, base0, start, blocks


@pytest.mark.parametrize("privacy", [False, True])
def test_two_silo_fedllm_federation_under_dp_clip(tmp_path, privacy):
    """Under dp_clip alone, and with the server's accounted DP on top
    (``privacy: dp``, whose clip of 0.5 matches the client's: the server's
    re-clip of each upload against its global is then the upload itself,
    and the published model carries both noises)."""
    over = {k: v for k, v in DP.items()
            if k not in ("comm_round", "client_num_per_round", "client_num_in_total",
                         "random_seed")}
    over["dp_solution_type"] = "dp_clip"
    if privacy:
        over.update(privacy="dp", dp_l2_clip=0.5, dp_noise_multiplier=1.0, dp_seed=3)
    agg, clients, base0, start, blocks = _run_federation(
        tmp_path, f"llm_dp_clip_{privacy}", over)
    weights = [len(blocks[i]) for i in sorted(blocks)]
    assert len(agg.uploads) == len(agg.folds) == len(agg.published) == 2
    sigma = 0.5 * 1.0 / sum(weights)  # DP-Clip's z C / qW
    assert TDP.get_instance().frame.sigma() == pytest.approx(sigma)
    if privacy:  # and the server's z C / n on the mean of n = 2
        sigma = math.hypot(sigma, 1.0 * 0.5 / 2)
    incoming = start
    for r in range(2):
        ups = agg.uploads[r]
        assert [n for n, _ in ups] == weights
        for _, up in ups:
            assert np.linalg.norm(_flat(up) - _flat(incoming)) <= 0.5 * (1 + 1e-6)
        mean = sum(n * _flat(up) for n, up in ups) / sum(weights)
        fold = _flat(params_to_jax(agg.folds[r]))
        assert np.abs(fold - mean).max() <= 1e-6 * np.abs(mean).max()
        published = _flat(params_to_jax(agg.published[r]))
        assert_draws(published - fold, sigma)
        incoming = params_to_jax(agg.published[r])
    assert math.isfinite(TDP.get_instance().get_epsilon(1e-5))
    for rank, client in clients.items():
        for n, p in client.llm.model.named_parameters():
            if n in base0[rank]:
                assert torch.equal(p, base0[rank][n]), (rank, n)
