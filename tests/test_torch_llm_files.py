"""HF llama checkpoints, text corpora and pretrained weights in the port,
against the JAX package, on the CPU.

A TINY llama (vocab 300, d_model 64, 2 layers, 4 heads over 2 KV heads,
d_ff 128) is initialised by the JAX package and exported with its
``export_hf_checkpoint`` beside a ``tokenizer.json``; both packages then
read it. Tolerances:

- safetensors files, the imported tensors, the export/import round trips,
  the packed text blocks and their batches, the hub's pretrained weights:
  bit-equal;
- logits of the imported models, f32 on both sides: within 1e-5 of their
  scale (two summation orders of f32 matmuls at width 64);
- ``LLMTrainer`` on the checkpoint and a corpus, f32, JAX with
  ``attention_impl="xla"``: the loss after 2 AdamW steps within 1e-4 and the
  adapters within 1e-4 (``tests/test_torch_llm_trainer.py``'s limits);
- greedy decoding from ``LLMPredictor.from_checkpoint`` in f32: the same
  text. JAX's ``from_checkpoint`` decodes in bf16; both packages' config is
  switched to f32 for the comparison, because a bf16 tie may round apart.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.models import model_hub as jhub
from fedml_tpu.models import transformer as jt
from fedml_tpu.serving.fedml_predictor import LLMPredictor as JPredictor
from fedml_tpu.train.llm import checkpoint_import as jci
from fedml_tpu.train.llm import configurations as jc
from fedml_tpu.train.llm import data as jdata
from fedml_tpu.train.llm import llm_trainer as jlt
from fedml_tpu.train.llm import safetensors_io as jst
from fedml_tpu.train.llm import tokenizer as jtok
from fedml_tpu_torch.models import transformer as tt
from fedml_tpu_torch.models.convert import params_from_jax, params_to_jax
from fedml_tpu_torch.serving import LLMPredictor
from fedml_tpu_torch.train.llm import checkpoint_import as tci
from fedml_tpu_torch.train.llm import configurations as tc
from fedml_tpu_torch.train.llm import data as tdata
from fedml_tpu_torch.train.llm import llm_trainer as tlt
from fedml_tpu_torch.train.llm import safetensors_io as tst
from fedml_tpu_torch.train.llm import tokenizer as ttok

GEOM = dict(vocab_size=300, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128)
CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "federated silos fine tune adapters and send only the adapters",
    "serving answers requests one token at a time from a key value cache",
    "a checkpoint carries the base weights and the tokenizer beside them",
]


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


def _np(v):
    return v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        x, y = _np(la[k]), _np(lb[k])
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), k


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """JAX-initialised TINY llama params, their HF checkpoint (JAX's export)
    with a tokenizer.json, and a text corpus."""
    root = tmp_path_factory.mktemp("llm_files")
    jcfg = jt.TransformerConfig(dtype=jnp.float32, max_seq_len=64, **GEOM)
    params = jax.device_get(jt.TransformerLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    model_dir = str(root / "hf")
    jci.export_hf_checkpoint(params, jcfg, model_dir)
    jtok.train_bpe(CORPUS * 3, vocab_size=GEOM["vocab_size"]).save(
        os.path.join(model_dir, "tokenizer.json"))
    corpus = root / "corpus"
    corpus.mkdir()
    (corpus / "a.txt").write_text("\n".join(CORPUS * 6) + "\n")
    (corpus / "b.jsonl").write_text("".join(json.dumps({"text": t}) + "\n" for t in CORPUS * 4))
    return {"params": params, "jcfg": jcfg, "dir": model_dir, "corpus": str(corpus),
            "root": root}


# --- safetensors -------------------------------------------------------------------------

def test_safetensors_round_trip_with_bf16_both_ways(tmp_path):
    import ml_dtypes

    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    bf16 = torch.from_numpy(rng.standard_normal((4, 2)).astype(np.float32)).to(torch.bfloat16)
    ints = rng.integers(-9, 9, (7,)).astype(np.int64)
    tst.save_safetensors({"a": f32, "b": bf16, "c": ints}, str(tmp_path / "port.safetensors"),
                         metadata={"format": "pt"})
    jst.save_safetensors({"a": f32, "b": bf16.float().numpy().astype(ml_dtypes.bfloat16),
                          "c": ints}, str(tmp_path / "jax.safetensors"), metadata={"format": "pt"})
    assert (tmp_path / "port.safetensors").read_bytes() == \
        (tmp_path / "jax.safetensors").read_bytes()
    got = tst.load_safetensors(str(tmp_path / "jax.safetensors"))
    assert got["b"].dtype == torch.bfloat16 and torch.equal(got["b"], bf16)
    assert np.array_equal(got["a"], f32) and np.array_equal(got["c"], ints)
    ref = jst.load_safetensors(str(tmp_path / "port.safetensors"))
    assert np.array_equal(ref["b"].view(np.uint16), got["b"].view(torch.int16).numpy()
                          .view(np.uint16))
    with pytest.raises(ValueError, match="unsupported dtype"):
        tst.save_safetensors({"x": np.zeros(2, np.complex64)}, str(tmp_path / "bad"))


def test_the_port_reads_bf16_without_ml_dtypes(tmp_path):
    t = torch.arange(6, dtype=torch.float32).to(torch.bfloat16)
    tst.save_safetensors({"w": t}, str(tmp_path / "w.safetensors"))
    code = ("import sys; from fedml_tpu_torch.train.llm import safetensors_io as s; "
            f"w = s.load_safetensors({str(tmp_path / 'w.safetensors')!r})['w']; "
            "assert w.dtype.is_floating_point and w.float().tolist() == [0, 1, 2, 3, 4, 5]; "
            "assert 'ml_dtypes' not in sys.modules and 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=os.getcwd(),
                   env={**os.environ, "PYTHONPATH": os.getcwd()})


def test_sharded_checkpoint_reads_as_jax_does(ckpt, tmp_path):
    raw = jst.load_checkpoint_tensors(ckpt["dir"])
    names = sorted(raw)
    shards = {"model-00001-of-00002.safetensors": names[::2],
              "model-00002-of-00002.safetensors": names[1::2]}
    for fname, keys in shards.items():
        jst.save_safetensors({k: raw[k] for k in keys}, str(tmp_path / fname))
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {k: f for f, keys in shards.items() for k in keys}}))
    got, ref = tst.load_checkpoint_tensors(str(tmp_path)), jst.load_checkpoint_tensors(str(tmp_path))
    assert sorted(got) == sorted(ref) == names
    assert all(np.array_equal(got[k], ref[k]) for k in names)
    with pytest.raises(FileNotFoundError, match="no safetensors"):
        tst.load_checkpoint_tensors(str(ckpt["root"]))


# --- the import --------------------------------------------------------------------------

def test_import_equals_jax_through_the_converter(ckpt):
    got = tci.import_hf_checkpoint(ckpt["dir"])
    ref = jax.device_get(jci.import_hf_checkpoint(ckpt["dir"]))
    _assert_trees_equal(got, ref)
    _assert_trees_equal(got, ckpt["params"])  # export then import is the identity
    tcfg, jcfg = tci.config_from_hf(ckpt["dir"]), jci.config_from_hf(ckpt["dir"])
    for f in ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_ff",
              "max_seq_len", "rope_theta"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    model = tt.TransformerLM(dataclasses.replace(tcfg, dtype=torch.float32))
    model.load_state_dict(params_from_jax(got))
    _assert_trees_equal(params_to_jax(model), ref)
    perm = tci._rope_perm(4, 16)
    assert np.array_equal(perm, jci._rope_perm(4, 16))
    assert np.array_equal(perm[tci._rope_perm(4, 16, inverse=True)], np.arange(64))


def test_imported_logits_equal_jax(ckpt):
    toks = np.random.default_rng(1).integers(0, GEOM["vocab_size"], (2, 16)).astype(np.int32)
    jcfg = dataclasses.replace(jci.config_from_hf(ckpt["dir"]), dtype=jnp.float32)
    ref = np.asarray(jt.TransformerLM(jcfg).apply(
        {"params": jci.import_hf_checkpoint(ckpt["dir"])}, jnp.asarray(toks)))
    model = tt.TransformerLM(dataclasses.replace(tci.config_from_hf(ckpt["dir"]),
                                                 dtype=torch.float32))
    model.load_state_dict(params_from_jax(tci.import_hf_checkpoint(ckpt["dir"])))
    with torch.no_grad():
        got = model(torch.from_numpy(toks)).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_export_round_trips_are_exact(ckpt, tmp_path):
    """The port's f32 export writes JAX's bytes; a bf16 export imports to
    f32 exactly and re-exports to the same bytes."""
    tci.export_hf_checkpoint(tci.import_hf_checkpoint(ckpt["dir"]), tci.config_from_hf(ckpt["dir"]),
                             str(tmp_path / "f32"))
    for f in ("model.safetensors", "config.json"):
        assert (tmp_path / "f32" / f).read_bytes() == open(os.path.join(ckpt["dir"], f), "rb").read()
    cfg = tci.config_from_hf(ckpt["dir"])
    tci.export_hf_checkpoint(ckpt["params"], cfg, str(tmp_path / "bf16"), dtype=torch.bfloat16)
    raw = tst.load_checkpoint_tensors(str(tmp_path / "bf16"))
    assert all(v.dtype == torch.bfloat16 for v in raw.values())
    imported = tci.import_hf_checkpoint(str(tmp_path / "bf16"))
    tci.export_hf_checkpoint(imported, cfg, str(tmp_path / "again"), dtype=torch.bfloat16)
    for f in ("model.safetensors", "config.json"):
        assert (tmp_path / "again" / f).read_bytes() == (tmp_path / "bf16" / f).read_bytes()
    emb = imported["embed"]["embedding"]
    want = torch.from_numpy(np.asarray(ckpt["params"]["embed"]["embedding"])).to(torch.bfloat16)
    assert emb.dtype == np.float32 and np.array_equal(emb, want.float().numpy())
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        tci.export_hf_checkpoint(imported, cfg, str(tmp_path / "f16"), dtype=np.float16)


# --- text corpora and the trainer --------------------------------------------------------

def test_text_dataset_from_path_equals_jax(ckpt):
    ttk = ttok.BPETokenizer.load(os.path.join(ckpt["dir"], "tokenizer.json"))
    jtk = jtok.BPETokenizer.load(os.path.join(ckpt["dir"], "tokenizer.json"))
    got = tdata.TextDataset.from_path(ckpt["corpus"], ttk, 32)
    ref = jdata.TextDataset.from_path(ckpt["corpus"], jtk, 32)
    assert got.blocks.dtype == ref.blocks.dtype and np.array_equal(got.blocks, ref.blocks)
    for a, b in zip(got.batches(3, 5, seed=2), ref.batches(3, 5, seed=2)):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    empty = ckpt["root"] / "empty_corpus"
    empty.mkdir(exist_ok=True)
    for cls, tk in ((tdata.TextDataset, ttk), (jdata.TextDataset, jtk)):
        with pytest.raises(ValueError, match="no text found"):
            cls.from_path(str(empty), tk, 32)


def _trainers(ckpt, tmp_path, **model_over):
    model = dict(model_name_or_path=ckpt["dir"], seq_len=32, lora_rank=4, remat=False,
                 attention_impl="xla", **model_over)
    exp = dict(max_steps=2, per_device_batch_size=2, learning_rate=1e-2, warmup_steps=1)
    data = dict(dataset_path=ckpt["corpus"])
    jtr = jlt.LLMTrainer(jc.ModelArguments(**model), jc.DatasetArguments(**data),
                         jc.ExperimentArguments(output_dir=str(tmp_path / "jax"), **exp))
    jtr.cfg = dataclasses.replace(jtr.cfg, dtype=jnp.float32)
    jtr.model = jt.TransformerLM(jtr.cfg)
    p0 = jax.device_get(jtr.init_params())
    jtr._build(p0)
    ttr = tlt.LLMTrainer(tc.ModelArguments(**model), tc.DatasetArguments(**data),
                         tc.ExperimentArguments(output_dir=str(tmp_path / "torch"), **exp),
                         device="cpu")
    ttr.cfg = dataclasses.replace(ttr.cfg, dtype=torch.float32)
    return jtr, ttr, p0


def test_trainer_on_a_checkpoint_and_a_corpus_tracks_jax(ckpt, tmp_path):
    jtr, ttr, p0 = _trainers(ckpt, tmp_path)
    for f in ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_ff"):
        assert getattr(ttr.model_args, f) == getattr(jtr.model_args, f) == GEOM[f], f
    # the random init, then the checkpoint's base over it: the base is the
    # checkpoint's whatever the seed, the adapters the init's
    model = ttr.init_params(seed=5)
    own = dict(model.named_parameters())
    emb = ckpt["params"]["embed"]["embedding"]
    assert np.array_equal(own["embed.embedding"].detach().numpy(), emb)
    assert np.array_equal(own["layer_1.mlp.up_proj.weight"].detach().numpy(),
                          ckpt["params"]["layer_1"]["mlp"]["up_proj"]["kernel"].T)
    assert "layer_0.attn.q_proj.lora_a" in own
    ttr._build(ttr.init_params(from_jax=p0))
    for a, b in zip(ttr.text_batches(2, 3), jtr.text_batches(2, 3)):
        assert np.array_equal(a[0], b[0])
    jm, tm = jtr.train(), ttr.train()  # batches from dataset_path
    assert tm["steps"] == jm["steps"] == 2
    assert abs(tm["final_loss"] - jm["final_loss"]) < 1e-4
    got = _leaves(ttr.adapter_params())
    from fedml_tpu.models.lora import split_lora as j_split

    moved = 0.0
    for path, want in _leaves(j_split(jax.device_get(jtr.params))[0]).items():
        np.testing.assert_allclose(got[path], np.asarray(want), atol=1e-4, err_msg=str(path))
        moved = max(moved, float(np.abs(np.asarray(want) - _leaves(p0)[path]).max()))
    assert moved > 1e-3
    assert np.array_equal(ttr.model.embed.embedding.detach().numpy(), emb)


def test_fedllm_client_reaches_the_checkpoint_and_corpus_through_args(ckpt, tmp_path):
    """LLMClientTrainer takes model_name_or_path and llm_dataset_path from the
    flat args, as JAX's: the base is the checkpoint's, the adapters cross."""
    from types import SimpleNamespace

    from fedml_tpu_torch.train.llm.fed_llm_trainer import LLMClientTrainer

    args = SimpleNamespace(model_name_or_path=ckpt["dir"], llm_dataset_path=ckpt["corpus"],
                           seq_len=32, lora_rank=4, remat=False, attention_impl="xla",
                           per_device_batch_size=2, local_steps=1, learning_rate=1e-2,
                           warmup_steps=1, output_dir=str(tmp_path / "client"))
    client = LLMClientTrainer(args, device="cpu")
    assert client.llm.cfg.d_model == GEOM["d_model"] and client.llm.data_args.dataset_path
    assert np.array_equal(client.llm.model.embed.embedding.detach().numpy(),
                          ckpt["params"]["embed"]["embedding"])
    adapters = client.get_model_params()
    assert set(adapters["layer_0"]["attn"]) == {"q_proj", "k_proj", "v_proj", "o_proj"}
    metrics = client.llm.train(client.llm.text_batches(2, 1))
    assert metrics["steps"] == 1 and np.isfinite(metrics["final_loss"])


def test_trainer_refusals_as_jax(ckpt, tmp_path):
    """A corpus dir with no text and no tokenizer raises what the JAX
    package raises."""
    exp = dict(max_steps=1, per_device_batch_size=2)
    (tmp_path / "no_text").mkdir()
    for tr, mc, dc, ec, kw in ((tlt, tc, tc, tc, {"device": "cpu"}), (jlt, jc, jc, jc, {})):
        t = tr.LLMTrainer(mc.ModelArguments(seq_len=32, lora_rank=4, remat=False,
                                            attention_impl="xla", **GEOM),
                          dc.DatasetArguments(dataset_path=str(tmp_path / "no_text")),
                          ec.ExperimentArguments(output_dir=str(tmp_path / tr.__name__), **exp),
                          **kw)
        with pytest.raises(ValueError, match="no tokenizer_path and no corpus"):
            next(iter(t.text_batches(2, 1)))


# --- serving -----------------------------------------------------------------------------

def _f32_config(monkeypatch):
    """Both packages' config_from_hf in f32 (their decode defaults to bf16)."""
    for mod, dt in ((jci, jnp.float32), (tci, torch.float32)):
        orig = mod.config_from_hf
        monkeypatch.setattr(mod, "config_from_hf",
                            lambda d, _o=orig, _dt=dt, **kw: _o(d, dtype=_dt, **kw))


def test_from_checkpoint_decodes_as_jax_does(ckpt, monkeypatch):
    _f32_config(monkeypatch)
    ref = JPredictor.from_checkpoint(ckpt["dir"], default_max_new_tokens=8)
    got = LLMPredictor.from_checkpoint(ckpt["dir"], default_max_new_tokens=8, device="cpu")
    assert got._eos_id == ref._eos_id
    for prompt in ("the quick brown", "federated silos", "a"):
        assert got.predict({"prompt": prompt}) == ref.predict({"prompt": prompt}), prompt
    assert got.predict_many([{"prompt": "fox"}, {"prompt": "dog"}]) == \
        ref.predict_many([{"prompt": "fox"}, {"prompt": "dog"}])


def test_from_checkpoint_reads_eos_from_config(ckpt, tmp_path, monkeypatch):
    import shutil

    _f32_config(monkeypatch)
    d = tmp_path / "llama3"
    shutil.copytree(ckpt["dir"], d)
    cfg = json.loads((d / "config.json").read_text())
    for eos, want in (([7, 9], (7, 9)), (5, 5)):
        (d / "config.json").write_text(json.dumps({**cfg, "eos_token_id": eos}))
        got = LLMPredictor.from_checkpoint(str(d), device="cpu")
        assert got._eos_id == want == JPredictor.from_checkpoint(str(d))._eos_id


def test_from_checkpoint_refuses_int8_before_the_import(tmp_path):
    """int8 is a known mode now (tests/test_torch_serving_quant.py serves
    it): on an empty dir it reaches the import and fails there, as JAX
    does; an unknown mode is still refused before any import."""
    with pytest.raises(FileNotFoundError, match="config.json"):
        LLMPredictor.from_checkpoint(str(tmp_path), quantize="int8", device="cpu")
    with pytest.raises(FileNotFoundError, match="config.json"):
        JPredictor.from_checkpoint(str(tmp_path), quantize="int8")
    with pytest.raises(ValueError, match="unknown quantize mode"):
        LLMPredictor.from_checkpoint(str(tmp_path), quantize="fp4")


# --- the hub: LLM names and pretrained_path ----------------------------------------------

def _hub_args(pkg, **kw):
    return pkg.default_config("simulation", dataset="shakespeare", seq_len=16, lora_rank=0,
                              remat=False, **{**GEOM, **kw})


@pytest.mark.parametrize("name", ["llama", "gpt", "transformer"])
def test_hub_builds_the_llm_names_as_jax_does(name):
    """``TransformerLM`` from ``TransformerConfig.from_args``; JAX's params
    carried over give JAX's logits (bf16 compute on both sides, the hub's
    default: within 2e-2 of their scale; measured 8.8e-3, a bf16 rounding
    of the activations taken in another order)."""
    jm = jhub.create(_hub_args(fedml_tpu, model=name), 90)
    tm = fedml_tpu_torch.model.create(_hub_args(fedml_tpu_torch, model=name), 90, device="cpu")
    assert tm.input_shape == jm.input_shape == (1, 16) and tm.input_dtype == torch.int32
    jparams = jax.device_get(jm.params)
    state = params_from_jax(jparams)
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in tm.params.items()}
    toks = np.random.default_rng(3).integers(0, GEOM["vocab_size"], (2, 16)).astype(np.int32)
    ref = np.asarray(jm.apply(jparams, jnp.asarray(toks))).astype(np.float32)
    with torch.no_grad():
        got = tm.apply(state, torch.from_numpy(toks)).numpy()
    assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


def test_pretrained_path_from_an_hf_dir_and_a_checkpoint_dir(ckpt, tmp_path):
    ref = jax.device_get(jhub.create(_hub_args(fedml_tpu, model="llama",
                                               pretrained_path=ckpt["dir"]), 90).params)
    tm = fedml_tpu_torch.model.create(_hub_args(fedml_tpu_torch, model="llama",
                                                pretrained_path=ckpt["dir"]), 90, device="cpu")
    _assert_trees_equal(params_to_jax(tm.params), ref)
    _assert_trees_equal(params_to_jax(tm.module), ref)
    from fedml_tpu_torch.utils.checkpoint import CheckpointManager

    CheckpointManager(str(tmp_path / "port_ckpt")).save(3, tm.params)
    again = fedml_tpu_torch.model.create(_hub_args(fedml_tpu_torch, model="llama",
                                                   pretrained_path=str(tmp_path / "port_ckpt")),
                                         90, device="cpu")
    _assert_trees_equal(params_to_jax(again.params), ref)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        fedml_tpu_torch.model.create(_hub_args(fedml_tpu_torch, model="llama",
                                               pretrained_path=str(tmp_path / "empty")), 90,
                                     device="cpu")


def test_pretrained_path_from_a_jax_npz(tmp_path):
    """A CNN's params saved by the JAX hub's save_pretrained_npz load into the
    port's CNN through the converter (conv and dense kernels re-laid); a
    missing key and a wrong shape raise JAX's errors."""
    kw = dict(model="cnn", dataset="mnist")
    jm = jhub.create(fedml_tpu.default_config("simulation", **kw), 10, seed=4)
    path = jhub.save_pretrained_npz(jm.params, str(tmp_path / "cnn.npz"))
    ref = jhub.create(fedml_tpu.default_config("simulation", pretrained_path=path, **kw), 10)
    tm = fedml_tpu_torch.model.create(fedml_tpu_torch.default_config(
        "simulation", pretrained_path=path, **kw), 10, device="cpu")
    _assert_trees_equal(params_to_jax(tm.params), jax.device_get(ref.params))
    with np.load(path) as z:
        arrays = dict(z)
    first = sorted(arrays)[0]
    np.savez(tmp_path / "missing.npz", **{k: v for k, v in arrays.items() if k != first})
    np.savez(tmp_path / "shape.npz", **{**arrays, first: np.zeros((1, 2, 3), np.float32)})
    for bad, err, match in ((tmp_path / "missing.npz", KeyError, "missing"),
                            (tmp_path / "shape.npz", ValueError, "shape")):
        for pkg, hub in ((fedml_tpu, jhub), (fedml_tpu_torch, None)):
            args = pkg.default_config("simulation", pretrained_path=str(bad), **kw)
            with pytest.raises(err, match=match):
                jhub.create(args, 10) if hub else pkg.model.create(args, 10, device="cpu")


def test_a_jax_orbax_dir_is_refused(tmp_path):
    """The port does not load orbax: a JAX checkpoint dir raises ValueError
    naming ROADMAP.md, where JAX restores it."""
    from fedml_tpu.utils.checkpoint import CheckpointManager as JCkpt

    jm = jhub.create(fedml_tpu.default_config("simulation", model="lr", dataset="mnist"), 10)
    mgr = JCkpt(str(tmp_path / "orbax"))
    mgr.save(1, jax.device_get(jm.params))
    mgr.wait_until_finished()
    ref = jhub.create(fedml_tpu.default_config("simulation", model="lr", dataset="mnist",
                                               pretrained_path=str(tmp_path / "orbax")), 10)
    _assert_trees_equal(jax.device_get(ref.params), jax.device_get(jm.params))
    with pytest.raises(ValueError, match="orbax.*ROADMAP"):
        fedml_tpu_torch.model.create(fedml_tpu_torch.default_config(
            "simulation", model="lr", dataset="mnist", pretrained_path=str(tmp_path / "orbax")),
            10, device="cpu")
