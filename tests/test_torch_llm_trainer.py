"""fedml_tpu_torch LLM trainer slice against the JAX package.

Loss, adapter gradients, the optimizer chain (schedule, clip, AdamW), three
LLMTrainer steps on identical numpy batches from the same converted init,
the federated client's adapter exchange, data and checkpoints. The JAX side
runs the Pallas flash kernels in interpret mode (attention_impl="pallas"),
the port their plain versions. Both trainers are switched to f32 compute for
the comparison (their configs default to bf16), at atol 1e-4.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from fedml_tpu.models import transformer as jt
from fedml_tpu.models.lora import split_lora as j_split
from fedml_tpu.parallel.fsdp import causal_lm_loss as j_loss
from fedml_tpu.train.llm import configurations as jc
from fedml_tpu.train.llm import data as jdata
from fedml_tpu.train.llm import llm_trainer as jlt
from fedml_tpu_torch.models import transformer as tt
from fedml_tpu_torch.models.convert import params_from_jax
from fedml_tpu_torch.models.lora import split_lora
from fedml_tpu_torch.parallel.fsdp import causal_lm_loss
from fedml_tpu_torch.train.llm import configurations as tc
from fedml_tpu_torch.train.llm import data as tdata
from fedml_tpu_torch.train.llm import llm_trainer as tlt
from fedml_tpu_torch.train.llm.fed_llm_trainer import LLMClientTrainer
from fedml_tpu_torch.train.llm.optim import AdamW, clip_by_global_norm_, warmup_cosine_decay_schedule

MODEL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
             seq_len=32, lora_rank=4, remat=False, attention_impl="pallas")
EXP = dict(max_steps=3, per_device_batch_size=2, learning_rate=1e-2, warmup_steps=1)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("masked", [False, True])
def test_causal_lm_loss_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 9, 50)).astype(np.float32) * 3
    toks = rng.integers(0, 50, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) > 0.3).astype(np.float32) if masked else None
    want = float(j_loss(jnp.asarray(logits), jnp.asarray(toks),
                        None if mask is None else jnp.asarray(mask)))
    got = causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(toks),
                         None if mask is None else torch.from_numpy(mask)).item()
    assert abs(got - want) < 1e-6


def _jax_model_and_params(seed=0):
    cfg = jt.TransformerConfig(dtype=jnp.float32, **{k: v for k, v in MODEL.items()
                                                     if k != "seq_len"}, max_seq_len=32)
    params = jax.device_get(jt.TransformerLM(cfg).init(jax.random.PRNGKey(seed),
                                                       jnp.zeros((1, 8), jnp.int32))["params"])
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: rng.normal(0, 0.05, v.shape).astype(np.float32)
        if p[-1].key == "lora_b" else np.array(v), params)
    return jt.TransformerLM(cfg), params


def test_adapter_grads_match_jax():
    """Loss and the adapter gradients of the whole model (GQA, flash path)."""
    jmodel, params = _jax_model_and_params()
    toks = np.random.default_rng(1).integers(0, 256, (2, 32)).astype(np.int32)

    def loss_fn(p):
        return j_loss(jmodel.apply({"params": p}, jnp.asarray(toks)), jnp.asarray(toks))

    j_l, j_g = jax.value_and_grad(loss_fn)(params)
    j_adapters, _ = j_split(jax.device_get(j_g))
    model = tt.TransformerLM(tt.TransformerConfig(
        dtype=torch.float32, max_seq_len=32, **{k: v for k, v in MODEL.items() if k != "seq_len"}))
    model.load_state_dict(params_from_jax(params))
    for name, p in model.named_parameters():
        p.requires_grad_(tlt.is_lora_name(name))
    tokens = torch.from_numpy(toks)
    loss = causal_lm_loss(model(tokens), tokens)
    loss.backward()
    assert abs(loss.item() - float(j_l)) < 1e-5
    grads = params_from_jax(j_adapters)
    own = dict(model.named_parameters())
    assert grads.keys() == {n for n, p in own.items() if p.requires_grad}
    for name, g in grads.items():
        np.testing.assert_allclose(own[name].grad.numpy(), g.numpy(), atol=1e-5, err_msg=name)


@pytest.mark.parametrize("warmup,total", [(3, 10), (0, 5), (10, 11)])
def test_schedule_matches_optax(warmup, total):
    want = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup, total)
    got = warmup_cosine_decay_schedule(0.0, 1e-3, warmup, total)
    for count in range(total + 3):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6, abs=1e-12), count
    if warmup:  # optax's 0-based count: the first step has lr 0
        assert got(0) == 0.0 == float(want(0))


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_matches_optax(scale):
    """Below the norm: untouched; above: g / norm * max_norm, no epsilon."""
    rng = np.random.default_rng(2)
    grads = [rng.standard_normal(s).astype(np.float32) * scale for s in ((4, 3), (7,))]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    clip_by_global_norm_(got, 1.0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_adamw_chain_matches_optax():
    """Three updates of clip + adamw(schedule, wd) against the optax chain."""
    rng = np.random.default_rng(3)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((5, 4), (3,))]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) * 2 for p in p0] for _ in range(3)]
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 1, 4)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched, weight_decay=0.1))
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = AdamW(params, warmup_cosine_decay_schedule(0.0, 1e-2, 1, 4), grad_clip=1.0,
                weight_decay=0.1)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
        opt.zero_grad()
    for a, b in zip(params, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-7)


def test_synthetic_batches_bit_identical():
    for (jt_, jm), (tt_, tm) in zip(jlt.synthetic_token_batches(300, 17, 3, 4, seed=7),
                                    tlt.synthetic_token_batches(300, 17, 3, 4, seed=7)):
        assert jt_.dtype == tt_.dtype and np.array_equal(jt_, tt_) and np.array_equal(jm, tm)


def test_data_pipeline_matches_jax():
    streams = [list(range(i, i + 7 * i)) for i in range(1, 9)]
    blocks = tdata.pack_tokens(streams, 16, eos_id=0)
    assert np.array_equal(blocks, jdata.pack_tokens(streams, 16, eos_id=0))
    for a, b in zip(tdata.TextDataset(blocks).batches(5, 6, seed=3),
                    jdata.TextDataset(blocks).batches(5, 6, seed=3)):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    for a, b in zip(tdata.client_shards(tdata.TextDataset(blocks), 3, seed=1),
                    jdata.client_shards(jdata.TextDataset(blocks), 3, seed=1)):
        assert np.array_equal(a.blocks, b.blocks)


def _trainers(tmp_path):
    """The JAX trainer and the port's, on one converted init, in f32."""
    jtr = jlt.LLMTrainer(jc.ModelArguments(**MODEL), jc.DatasetArguments(),
                         jc.ExperimentArguments(output_dir=str(tmp_path / "jax"), **EXP))
    jtr.cfg = dataclasses.replace(jtr.cfg, dtype=jnp.float32)
    jtr.model = jt.TransformerLM(jtr.cfg)
    p0 = jax.device_get(jtr.init_params())
    jtr._build(p0)
    ttr = tlt.LLMTrainer(tc.ModelArguments(**MODEL), tc.DatasetArguments(),
                         tc.ExperimentArguments(output_dir=str(tmp_path / "torch"), **EXP),
                         device="cpu")
    ttr.cfg = dataclasses.replace(ttr.cfg, dtype=torch.float32)
    ttr._build(ttr.init_params(from_jax=p0))
    return jtr, ttr, p0


def test_three_trainer_steps_match_jax(tmp_path):
    """Loss per step and adapters after three steps at f32 atol 1e-4; the
    port's base weights stay bit-unchanged (mirrors test_llm.py's
    test_lora_freezes_base)."""
    jtr, ttr, p0 = _trainers(tmp_path)
    base0 = {n: p.detach().clone() for n, p in ttr.model.named_parameters()
             if not tlt.is_lora_name(n)}
    for batch in tlt.synthetic_token_batches(256, 32, 2, 3, seed=0):
        jm, tm = jtr.train(iter([batch])), ttr.train(iter([batch]))
        assert abs(jm["final_loss"] - tm["final_loss"]) < 1e-4
        assert tm["steps"] == 1 and tm["tokens_per_sec"] > 0
    assert ttr.optimizer.count == 3
    j_adapters, _ = j_split(jax.device_get(jtr.params))
    t_adapters = dict(_leaves(ttr.adapter_params()))
    moved = 0.0
    for path, want in _leaves(j_adapters):
        np.testing.assert_allclose(t_adapters[path], np.asarray(want), atol=1e-4, err_msg=str(path))
        moved = max(moved, float(np.abs(np.asarray(want) - dict(_leaves(p0))[path]).max()))
    assert moved > 1e-3  # the comparison is not of unmoved adapters
    for n, p in ttr.model.named_parameters():
        if n in base0:
            assert torch.equal(p, base0[n]), n
            assert p.grad is None and not p.requires_grad


def test_trainer_checkpoint_roundtrip(tmp_path):
    _, ttr, _ = _trainers(tmp_path)
    ttr.train()
    assert ttr.ckpt.latest_step() == 3
    saved = ttr.named_params()
    with torch.no_grad():
        for p in ttr.model.parameters():
            p.zero_()
    assert ttr.restore() is True
    for (path, a), (_, b) in zip(_leaves(ttr.named_params()), _leaves(saved)):
        assert np.array_equal(a, b), path


def _client_args(tmp_path, **over):
    return SimpleNamespace(**{**MODEL, "attention_impl": "auto", "per_device_batch_size": 2,
                              "local_steps": 2, "learning_rate": 1e-2, "warmup_steps": 1,
                              "output_dir": str(tmp_path / "client"), **over})


def test_client_trainer_adapter_exchange(tmp_path):
    """get/set move the adapter subtree in JAX split_lora's paths; a round on
    token blocks moves it; the base stays."""
    client = LLMClientTrainer(_client_args(tmp_path), device="cpu")
    _, params = _jax_model_and_params()
    j_adapters, _ = j_split(params)
    got = client.get_model_params()
    assert sorted(p for p, _ in _leaves(got)) == sorted(p for p, _ in _leaves(j_adapters))
    assert got.keys() == split_lora(client.llm.named_params())[0].keys()
    client.set_model_params(j_adapters)
    for (path, a), (_, b) in zip(sorted(_leaves(client.get_model_params())),
                                 sorted(_leaves(j_adapters))):
        assert np.array_equal(a, b), path
    _, base_before = split_lora(client.llm.named_params())
    blocks = np.random.default_rng(4).integers(0, 256, (5, 32)).astype(np.int32)
    metrics = client.train(blocks)
    assert metrics["steps"] == 2 and np.isfinite(metrics["final_loss"])
    after = dict(_leaves(client.get_model_params()))
    assert any(not np.array_equal(after[p], np.asarray(v)) for p, v in _leaves(j_adapters))
    _, base_after = split_lora(client.llm.named_params())
    for (path, a), (_, b) in zip(_leaves(base_after), _leaves(base_before)):
        assert np.array_equal(a, b), path
    with pytest.raises(ValueError, match="token blocks"):
        client.train(blocks[:, :16])


def test_client_trainer_requires_lora(tmp_path):
    with pytest.raises(ValueError, match="lora_rank"):
        LLMClientTrainer(_client_args(tmp_path, lora_rank=0), device="cpu")


@pytest.mark.parametrize("flag,over,refusal", [
    ("enable_dp", dict(dp_solution_type="dp_clip", clipping_norm=0.5), None),
    ("enable_attack", dict(attack_type="label_flipping"), "R15"),
    ("enable_fhe", dict(fhe_scheme="rlwe"), "R14"),
])
def test_client_hooks_run_or_refuse(tmp_path, flag, over, refusal):
    """The client hooks on the adapters: local DP runs (DP-Clip's upload
    within the clip of the incoming adapters); FHE and data poisoning raise
    naming their R-number (ROADMAP.md, Queue 3) before the first step."""
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy

    args = _client_args(tmp_path, **{flag: True}, **over)
    client = LLMClientTrainer(args, device="cpu")
    assert client.is_main_process()
    if refusal is not None:
        with pytest.raises(ValueError, match=refusal):
            client.on_before_local_training(None, None, args)
        with pytest.raises(ValueError, match=refusal):
            client.on_after_local_training(None, None, args)
        return
    dp = FedMLDifferentialPrivacy.get_instance()
    dp.init(args)
    try:
        before = np.concatenate([v.ravel() for _, v in sorted(_leaves(client.get_model_params()))])
        blocks = np.random.default_rng(4).integers(0, 256, (5, 32)).astype(np.int32)
        data = client.on_before_local_training(blocks, None, args)
        client.train(data, None, args)
        client.on_after_local_training(data, None, args)
        after = np.concatenate([v.ravel() for _, v in sorted(_leaves(client.get_model_params()))])
        assert 0 < np.linalg.norm(after.astype(np.float64) - before) <= 0.5 * (1 + 1e-6)
    finally:
        dp.init(SimpleNamespace())


@pytest.mark.parametrize("over", [dict(dp=2), dict(fsdp=2), dict(tp=2), dict(sp=2), dict(ep=2),
                                  dict(pp=2)])
def test_mesh_axes_raise(tmp_path, over):
    """dp, fsdp, tp, sp and ep train over a mesh of ranks
    (tests/test_torch_llm_mesh.py): without a process group of that many
    ranks the mesh raises JAX's ValueError. pp is not ported."""
    exc, match = ((NotImplementedError, "ROADMAP.md") if "pp" in over
                  else (ValueError, "mesh needs 2 devices, have 1"))
    with pytest.raises(exc, match=match):
        tlt.LLMTrainer(tc.ModelArguments(**MODEL), tc.DatasetArguments(),
                       tc.ExperimentArguments(output_dir=str(tmp_path), **over), device="cpu")


def test_unported_model_and_data_options_raise(tmp_path):
    """model_name_or_path and dataset_path are ported: on a directory with no
    config.json, and on one with no text, the port raises what JAX raises.
    MoE is ported (tests/test_torch_moe.py); the pipeline's local experts
    are not."""
    exp = tc.ExperimentArguments(output_dir=str(tmp_path), **EXP)
    jexp = jc.ExperimentArguments(output_dir=str(tmp_path / "jax"), **EXP)
    for tr, mc, e, kw in ((tlt, tc, exp, {"device": "cpu"}), (jlt, jc, jexp, {})):
        with pytest.raises(FileNotFoundError, match="config.json"):
            tr.LLMTrainer(mc.ModelArguments(model_name_or_path=str(tmp_path), **MODEL),
                          mc.DatasetArguments(), e, **kw)
    moe = tlt.LLMTrainer(tc.ModelArguments(**{**MODEL, "moe_experts": 2}), tc.DatasetArguments(),
                         exp, device="cpu")
    assert moe.cfg.moe_experts == 2 and moe.cfg.moe_ep_axis is None
    with pytest.raises(NotImplementedError, match="moe_local_experts"):
        tt.TransformerLM(tt.TransformerConfig(moe_experts=2, moe_local_experts=1))
    (tmp_path / "no_text").mkdir()
    ttr = tlt.LLMTrainer(tc.ModelArguments(**MODEL),
                         tc.DatasetArguments(dataset_path=str(tmp_path / "no_text")), exp,
                         device="cpu")
    jtr = jlt.LLMTrainer(jc.ModelArguments(**MODEL),
                         jc.DatasetArguments(dataset_path=str(tmp_path / "no_text")), jexp)
    with pytest.raises(ValueError, match="no tokenizer_path and no corpus"):
        ttr.train()
    with pytest.raises(ValueError, match="no tokenizer_path and no corpus"):
        jtr.text_batches(2, 1)  # what JAX's train() reads its batches from
