"""The port's MoE model against the JAX package's, on the CPU.

``fedml_tpu_torch/models/moe.py`` and the MoE branch of
``models/transformer.py`` against ``fedml_tpu/models/moe.py`` and
``fedml_tpu/models/transformer.py``. Inputs come from seeded numpy
generators; the JAX params are converted (``models/convert.py``).
Tolerances:

- ``moe_dispatch``: the dispatch tensors exactly (0/1), the drop set
  included (the capacity-overflow case of ``tests/test_moe.py``). JAX
  computes the router's softmax in float32 even under x64 (``moe.py:76``),
  and so does the port, so the gates in ``combine`` and the aux loss are
  held to f32 rounding, rtol 1e-6 (the two softmaxes' exp may differ in
  the last bit), not to float64's 1e-12.
- ``MoEMLP`` in float64 compute (routing f32 in both, as above): output and
  aux rtol 1e-6, every parameter's gradient rtol 1e-5 of its scale.
- the transformer with ``moe_experts=4`` under both remat policies (JAX's
  ``tests/test_moe_transformer.py``), float64 compute with f32 logits in
  both packages: logits atol 1e-5, aux rtol 1e-6, gradients 1e-5 of their
  scale; the aux reaches the loss once under remat.
- one ``LLMTrainer`` step against JAX's single-device MoE step
  (``tests/test_llm_moe.py``), both in f32: loss atol 1e-5, params 1e-4;
- greedy ``generate`` on a MoE model token for token, f32;
- ``convert.py`` round trip of the MoE params bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models import moe as jmoe
from fedml_tpu.models import transformer as jt
from fedml_tpu.parallel.fsdp import causal_lm_loss as j_loss
from fedml_tpu.train.llm import configurations as jc
from fedml_tpu.train.llm import generation as jg
from fedml_tpu.train.llm import llm_trainer as jlt
from fedml_tpu_torch.models import moe as tmoe
from fedml_tpu_torch.models import transformer as tt
from fedml_tpu_torch.models.convert import params_from_jax, params_to_jax
from fedml_tpu_torch.parallel.fsdp import causal_lm_loss
from fedml_tpu_torch.train.llm import configurations as tc
from fedml_tpu_torch.train.llm import generation as tg
from fedml_tpu_torch.train.llm import llm_trainer as tlt

E, D, FF, B, T = 4, 16, 32, 4, 8
GEOM = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
            max_seq_len=16, lora_rank=0, moe_experts=4)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _close_to_scale(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err} against scale {scale}"


# --- moe_dispatch -------------------------------------------------------------------

@pytest.mark.parametrize("n,e,capacity", [(32, 4, 40), (32, 4, 1), (64, 8, 5), (7, 3, 2)])
def test_moe_dispatch_matches_jax(n, e, capacity):
    """Ample capacity, capacity 1 (tests/test_moe.py:44's overflow: all but E
    tokens dropped), and partial overflow."""
    logits = np.random.default_rng(n * e + capacity).standard_normal((n, e)) * 2
    jd, jcomb, jaux = (np.asarray(a) for a in jmoe.moe_dispatch(jnp.asarray(logits), capacity))
    td, tcomb, taux = tmoe.moe_dispatch(torch.from_numpy(logits), capacity)
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_allclose(tcomb.numpy(), jcomb, rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    kept = jd.sum(axis=(1, 2)) > 0
    assert int(tmoe.dropped_tokens(td)) == int((~kept).sum())
    if capacity == 1:
        assert kept.sum() <= e


def test_moe_dispatch_uniform_router_aux_is_one():
    """tests/test_moe.py's aux check: uniform logits, every token to expert 0."""
    _, _, aux = tmoe.moe_dispatch(torch.zeros(64, E), capacity=64)
    np.testing.assert_allclose(float(aux), 1.0, rtol=1e-6)


# --- MoEMLP ---------------------------------------------------------------------------

def _jax_moe(capacity_factor, seed):
    with jax.enable_x64(True):
        cfg = jmoe.MoEConfig(n_experts=E, capacity_factor=capacity_factor, d_model=D, d_ff=FF,
                             dtype=jnp.float64)
        x = np.random.default_rng(seed).standard_normal((B, T, D))
        params = jax.device_get(jmoe.MoEMLP(cfg).init(jax.random.PRNGKey(seed),
                                                       jnp.asarray(x))["params"])

        def loss(p):
            y, aux = jmoe.MoEMLP(cfg).apply({"params": p}, jnp.asarray(x))
            return jnp.sum(y ** 2) + aux, (y, aux)

        (l, (y, aux)), g = jax.value_and_grad(loss, has_aux=True)(params)
        return x, params, np.asarray(y), float(aux), jax.device_get(g)


@pytest.mark.parametrize("capacity_factor", [float(E), 1.0, E / (B * T)])
def test_moe_mlp_forward_aux_and_grads_match_jax(capacity_factor):
    x, params, want_y, want_aux, want_g = _jax_moe(capacity_factor, seed=3)
    mod = tmoe.MoEMLP(tmoe.MoEConfig(n_experts=E, capacity_factor=capacity_factor, d_model=D,
                                     d_ff=FF, dtype=torch.float64))
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    assert mod.router.dtype == torch.float32  # JAX's f32 params
    y, aux = mod(torch.from_numpy(x))
    _close_to_scale(y.detach().numpy(), want_y, 1e-6, "output")
    np.testing.assert_allclose(float(aux.detach()), want_aux, rtol=1e-6)
    ((y ** 2).sum() + aux).backward()
    for name, g in want_g.items():
        _close_to_scale(getattr(mod, name).grad.numpy(), g, 1e-5, f"d{name}")
    assert float(mod.router.grad.abs().sum()) > 0  # load balancing is differentiable


# --- the transformer ------------------------------------------------------------------

def _jax_lm(remat, policy, seed=0):
    cfg = jt.TransformerConfig(dtype=jnp.float64, remat=remat, remat_policy=policy, **GEOM)
    toks = np.random.default_rng(seed).integers(0, GEOM["vocab_size"], (2, 16)).astype(np.int32)
    with jax.enable_x64(True):
        model = jt.TransformerLM(cfg)
        params = jax.device_get(model.init(jax.random.PRNGKey(seed), jnp.asarray(toks))["params"])

        def loss(p):
            logits, state = model.apply({"params": p}, jnp.asarray(toks), mutable=["losses"])
            aux = sum(jnp.sum(a) for a in jax.tree.leaves(state["losses"]))
            return j_loss(logits, jnp.asarray(toks)) + aux, (logits, aux)

        (l, (logits, aux)), g = jax.value_and_grad(loss, has_aux=True)(params)
        return toks, params, float(l), np.asarray(logits), float(aux), jax.device_get(g)


@pytest.mark.parametrize("remat,policy", [(False, "full"), (True, "full"), (True, "dots")])
def test_moe_transformer_matches_jax_under_remat(remat, policy):
    toks, params, want_l, want_logits, want_aux, want_g = _jax_lm(remat, policy)
    cfg = tt.TransformerConfig(dtype=torch.float64, remat=remat, remat_policy=policy, **GEOM)
    model = tt.TransformerLM(cfg).to(torch.float64)
    model.load_state_dict({k: v.to(torch.float64) for k, v in params_from_jax(params).items()})
    tokens = torch.from_numpy(toks)
    logits, aux = model(tokens)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), want_aux, rtol=1e-6)
    loss = causal_lm_loss(logits, tokens) + aux
    assert abs(float(loss) - want_l) < 1e-5
    loss.backward()
    own = dict(model.named_parameters())
    for name, g in params_from_jax(want_g).items():
        _close_to_scale(own[name].grad.numpy(), g.numpy(), 1e-5, name)


def test_moe_aux_reaches_the_loss_once_under_remat():
    """The aux is returned from each block, not collected on the side: a
    recomputed block adds nothing, so the router's gradient with remat is
    the one without."""
    grads = []
    for remat in (False, True):
        cfg = tt.TransformerConfig(dtype=torch.float64, remat=remat, **GEOM)
        model = tt.TransformerLM(cfg)
        gen = torch.Generator().manual_seed(2)
        model.reset_parameters(gen)
        model.to(torch.float64)
        logits, aux = model(torch.randint(0, 64, (2, 16), generator=gen))
        aux.backward()  # the aux alone: only the routers get a gradient
        grads.append(model.layer_0.moe_mlp.router.grad.clone())
    assert float(grads[0].abs().sum()) > 0
    torch.testing.assert_close(grads[1], grads[0], rtol=0, atol=0)


def test_moe_and_ring_configs_build_and_run():
    """The lifted gates: a MoE model and attention_impl="ring" train on one
    device (ring without an sp mesh is exact plain attention, as in JAX)."""
    toks = torch.randint(0, 64, (2, 16), generator=torch.Generator().manual_seed(0))
    for over in (dict(moe_experts=4), dict(attention_impl="ring", moe_experts=0),
                 dict(attention_impl="ring", moe_experts=2)):
        cfg = tt.TransformerConfig(**{**GEOM, **over, "dtype": torch.float32})
        model = tt.TransformerLM(cfg)
        model.reset_parameters(torch.Generator().manual_seed(1))
        out = model(toks)
        logits = out[0] if isinstance(out, tuple) else out
        assert logits.shape == (2, 16, 64) and torch.isfinite(logits).all()
    ring = tt.TransformerLM(tt.TransformerConfig(**{**GEOM, "moe_experts": 0,
                                                    "attention_impl": "ring"}))
    xla = tt.TransformerLM(tt.TransformerConfig(**{**GEOM, "moe_experts": 0,
                                                   "attention_impl": "xla"}))
    ring.reset_parameters(torch.Generator().manual_seed(1))
    xla.load_state_dict(ring.state_dict())
    torch.testing.assert_close(ring(toks), xla(toks), rtol=0, atol=0)


# --- the trainer, generation, the converter ----------------------------------------

MOE_TRAIN = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=4, n_kv_heads=4, d_ff=64,
                 seq_len=16, lora_rank=0, remat=False, moe_experts=2)
MOE_EXP = dict(max_steps=2, per_device_batch_size=2, learning_rate=1e-2, warmup_steps=1)


def test_llm_trainer_moe_steps_match_jax(tmp_path):
    """tests/test_llm_moe.py's single-device MoE trainer, step for step."""
    jtr = jlt.LLMTrainer(jc.ModelArguments(**MOE_TRAIN), jc.DatasetArguments(),
                         jc.ExperimentArguments(output_dir=str(tmp_path / "jax"), **MOE_EXP),
                         devices=jax.devices()[:1])
    jtr.cfg = dataclasses.replace(jtr.cfg, dtype=jnp.float32)
    jtr.model = jt.TransformerLM(jtr.cfg)
    p0 = jax.device_get(jtr.init_params())
    jtr._build(p0)
    ttr = tlt.LLMTrainer(tc.ModelArguments(**MOE_TRAIN), tc.DatasetArguments(),
                         tc.ExperimentArguments(output_dir=str(tmp_path / "torch"), **MOE_EXP),
                         device="cpu")
    ttr.cfg = dataclasses.replace(ttr.cfg, dtype=torch.float32)
    ttr._build(ttr.init_params(from_jax=p0))
    for batch in tlt.synthetic_token_batches(64, 16, 2, 2, seed=0):
        jm, tm = jtr.train(iter([batch])), ttr.train(iter([batch]))
        assert abs(jm["final_loss"] - tm["final_loss"]) < 1e-5
    got = dict(_leaves(ttr.named_params()))
    moved = 0.0
    for path, want in _leaves(jax.device_get(jtr.params)):
        np.testing.assert_allclose(got[path], np.asarray(want), atol=1e-4, err_msg=str(path))
        moved = max(moved, float(np.abs(np.asarray(want) - dict(_leaves(p0))[path]).max()))
    assert moved > 1e-3
    assert got[("layer_0", "moe_mlp", "w_gate")].shape == (2, 32, 64)


def test_moe_greedy_generate_matches_jax():
    geom = {**GEOM, "lora_rank": 2}
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **geom)
    jparams = jax.device_get(jt.TransformerLM(jcfg).init(jax.random.PRNGKey(4),
                                                         jnp.zeros((1, 8), jnp.int32))["params"])
    prompt = np.random.default_rng(5).integers(0, 64, (2, 5)).astype(np.int32)
    want = np.asarray(jg.generate(jparams, jcfg, jnp.asarray(prompt), 8))
    model = tg.decode_model(tt.TransformerConfig(dtype=torch.float32, **geom), jparams,
                            device="cpu")
    assert model.layer_0.moe_mlp.router.dtype == torch.float32
    got = tg.generate(model, model.cfg, prompt, 8, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_convert_round_trips_moe_params():
    """router [D, E] and the expert stacks keep flax's layout both ways (they
    are used as h @ w, not flipped like a Dense kernel); lora_* unchanged."""
    cfg = jt.TransformerConfig(dtype=jnp.float32, **{**GEOM, "lora_rank": 2})
    jparams = jax.device_get(jt.TransformerLM(cfg).init(jax.random.PRNGKey(6),
                                                        jnp.zeros((1, 8), jnp.int32))["params"])
    state = params_from_jax(jparams)
    assert state["layer_0.moe_mlp.router"].shape == (32, 4)
    assert state["layer_0.moe_mlp.w_gate"].shape == (4, 32, 64)
    assert state["layer_0.moe_mlp.w_down"].shape == (4, 64, 32)
    model = tt.TransformerLM(tt.TransformerConfig(dtype=torch.float32, **{**GEOM,
                                                                          "lora_rank": 2}))
    model.load_state_dict(state)  # every name and shape the port's
    back = dict(_leaves(params_to_jax(model)))
    want = dict(_leaves(jparams))
    assert back.keys() == want.keys()
    for path, v in want.items():
        assert np.array_equal(back[path], np.asarray(v)), path
