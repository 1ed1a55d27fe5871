"""The rest of the model hub (MobileNet v1/v3, EfficientNet-lite, the LSTMs,
the text classifier, the GAN pair, the DARTS supernet, SegNetLite), its
layers, and the datasets those models train on, against the JAX package,
on the CPU.

Each JAX model is initialised by flax and carried into the port through
``models/convert.py``; both run the same inputs (numpy, seeded).

Tolerances:

- the converter round trip and the flat wire vector: bit-exact;
- the forward: within ``rtol=1e-5`` with an absolute floor of 1e-5 of the
  output's largest magnitude (measured worst 3.5e-6 of the scale, on the
  GAN pair's logits; 2.2e-6 on EfficientNet-lite);
- one SGD step: the port's update (new - old params, one flat vector)
  within a relative L2 error of 1e-4 of JAX's (measured worst 4.2e-6, on
  MobileNet v3); the gradient comes from the same loss, the mean of the
  outputs weighted by a seeded random array;
- the transposed and grouped/dilated convolutions alone: as the forward;
- the datasets: bit-equal to JAX's ``data.load``, partition included.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.data import data_loader as jloader
from fedml_tpu.data import formats as jformats
from fedml_tpu.models import darts as jdarts
from fedml_tpu.models import efficientnet as jeff
from fedml_tpu.models import gan as jgan
from fedml_tpu.models import mobilenet as jmob
from fedml_tpu.models import rnn as jrnn
from fedml_tpu.models import segmentation as jseg
from fedml_tpu.models import text_classifier as jtc
from fedml_tpu.utils.pytree import tree_flatten_to_vector as jax_flatten
from fedml_tpu_torch.data import data_loader as tloader
from fedml_tpu_torch.models import darts as tdarts
from fedml_tpu_torch.models import efficientnet as teff
from fedml_tpu_torch.models import gan as tgan
from fedml_tpu_torch.models import layers
from fedml_tpu_torch.models import mobilenet as tmob
from fedml_tpu_torch.models import rnn as trnn
from fedml_tpu_torch.models import segmentation as tseg
from fedml_tpu_torch.models import text_classifier as ttc
from fedml_tpu_torch.models.convert import (
    params_from_jax,
    params_to_jax,
    state_from_wire_vector,
    wire_vector,
)

RTOL = 1e-5
STEP_TOL = 1e-4
LR = 0.1


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(shape=(2, 32, 32, 3)):
    return np.random.default_rng(0).standard_normal(shape).astype(np.float32)


def _tokens(vocab, shape, pad_rows=False):
    x = np.random.default_rng(0).integers(1, vocab, shape)
    if pad_rows:  # one all-pad row and one half-padded row: the finfo.min trap
        x[0] = 0
        x[1, shape[1] // 2:] = 0
    return x


TC_CFG = dict(vocab_size=50, max_seq_len=16, d_model=32, n_layers=2, n_heads=4, d_ff=64)

# name: (JAX module, port module, input); small widths where a model takes them
MODELS = {
    "gan": (lambda: jgan.GANPair(), lambda: tgan.GANPair(),
            lambda: np.random.default_rng(0).standard_normal((2, 64)).astype(np.float32)),
    "gan_32x32x3": (lambda: jgan.GANPair(image_hw=32, channels=3),
                    lambda: tgan.GANPair(image_hw=32, channels=3),
                    lambda: np.random.default_rng(0).standard_normal((2, 64)).astype(np.float32)),
    "segnet": (lambda: jseg.SegNetLite(3), lambda: tseg.SegNetLite(3), _images),
    "darts": (lambda: jdarts.DARTSNetwork(width=8, layers=2, steps=2),
              lambda: tdarts.DARTSNetwork(width=8, layers=2, steps=2), _images),
    "rnn": (lambda: jrnn.RNNOriginalFedAvg(hidden_size=32),
            lambda: trnn.RNNOriginalFedAvg(hidden_size=32), lambda: _tokens(90, (2, 12))),
    "rnn_stackoverflow": (lambda: jrnn.RNNStackOverflow(vocab_size=96, latent_size=40),
                          lambda: trnn.RNNStackOverflow(vocab_size=96, latent_size=40),
                          lambda: _tokens(100, (2, 12))),
    "text_classifier": (lambda: jtc.distilbert_shape(5, **TC_CFG),
                        lambda: ttc.distilbert_shape(5, **TC_CFG),
                        lambda: _tokens(50, (3, 16), pad_rows=True)),
    "mobilenet": (lambda: jmob.MobileNetV1(alpha=0.25), lambda: tmob.MobileNetV1(alpha=0.25),
                  _images),
    "mobilenet_v3": (lambda: jmob.MobileNetV3Small(), lambda: tmob.MobileNetV3Small(), _images),
    "efficientnet": (lambda: jeff.efficientnet_lite0(), lambda: teff.efficientnet_lite0(),
                     _images),
    "mobilenet_mnist": (lambda: jmob.MobileNetV1(alpha=0.25),
                        lambda: tmob.MobileNetV1(alpha=0.25, in_channels=1),
                        lambda: _images((2, 28, 28, 1))),
}

# the step at one input shape a model (the forward covers the others)
STEP_MODELS = [m for m in MODELS if m not in ("gan_32x32x3", "mobilenet_mnist")]


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    make_jax, _, make_x = MODELS[name]
    x = make_x()
    jm = make_jax()
    keys = {"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}
    return jm, jax.device_get(jm.init(keys, jnp.asarray(x), train=False)["params"]), x


def _pair(name):
    jm, params, x = _jax_init(name)
    port = MODELS[name][1]()
    port.load_state_dict(params_from_jax(params))
    return jm, params, port, x


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_jax(name):
    jm, params, port, x = _pair(name)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    _close(got, ref)


@pytest.mark.parametrize("name", STEP_MODELS)
def test_one_sgd_step_matches_jax(name):
    jm, params, port, x = _pair(name)
    out_shape = jm.apply({"params": params}, jnp.asarray(x)).shape
    r = np.random.default_rng(1).standard_normal(out_shape).astype(np.float32)

    def jloss(p):
        return jnp.mean(jm.apply({"params": p}, jnp.asarray(x)) * r)

    jgrads = jax.grad(jloss)(params)
    jnew = jax.tree.map(lambda p, g: p - LR * g, params, jgrads)
    loss = torch.mean(port(torch.from_numpy(x)) * torch.from_numpy(r))
    loss.backward()
    with torch.no_grad():
        for p in port.parameters():
            p -= LR * p.grad
    start = np.asarray(jax_flatten(params)[0])
    ref = np.asarray(jax_flatten(jnew)[0]) - start
    got = wire_vector(port.state_dict()).numpy() - start
    assert np.linalg.norm(ref) > 0
    assert np.linalg.norm(got - ref) <= STEP_TOL * np.linalg.norm(ref), \
        np.linalg.norm(got - ref) / np.linalg.norm(ref)


def test_padding_rows_stay_finite_and_a_minus_inf_mask_would_not():
    """A padding query row masks every key: flax fills finfo.min and softmaxes
    to uniform; -inf would give NaN, and the pool's NaN * 0 reaches every
    logit of the example."""
    jm, params, port, x = _pair("text_classifier")
    assert (x[0] == 0).all()
    with torch.no_grad():
        assert np.isfinite(port(torch.from_numpy(x)).numpy()).all()
        orig = torch.finfo
        try:
            torch.finfo = lambda dtype: type("F", (), {"min": -float("inf")})
            bad = port(torch.from_numpy(x)).numpy()
        finally:
            torch.finfo = orig
    assert np.isnan(bad[0]).all()


@pytest.mark.parametrize("kernel,stride,size", [(4, 2, 7), (4, 2, 8), (3, 2, 8), (3, 2, 5),
                                                (3, 1, 6), (2, 2, 5), (5, 3, 4), (1, 2, 3)])
def test_conv_transpose_is_flax_same(kernel, stride, size):
    """Both pad shapes: k=4, s=2 pads (2, 2) (torch padding=1); k=3, s=2
    pads (2, 1), which torch's padding cannot express (cropped)."""
    x = _images((2, size, size, 5))
    jm = fnn.ConvTranspose(3, (kernel, kernel), (stride, stride))
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    port = layers.ConvTranspose(5, 3, (kernel, kernel), (stride, stride))
    port.load_state_dict(params_from_jax(params))
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(layers.nhwc_to_nchw(torch.from_numpy(x))).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, size * stride, size * stride, 3)
    _close(got, ref)


def test_conv_transpose_padding_is_lax():
    from jax._src.lax.convolution import _conv_transpose_padding

    for k in range(1, 7):
        for s in range(1, 5):
            assert layers.conv_transpose_padding(k, s) == _conv_transpose_padding(k, s, "SAME")


@pytest.mark.parametrize("groups,dilation,stride,size", [(4, 1, 1, 8), (8, 1, 2, 8),
                                                         (1, 2, 1, 7), (2, 2, 2, 9)])
def test_grouped_and_dilated_conv_is_flax_same(groups, dilation, stride, size):
    x = _images((2, size, size, 8))
    jm = fnn.Conv(8, (3, 3), (stride, stride), feature_group_count=groups,
                  kernel_dilation=(dilation, dilation), use_bias=False)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    port = layers.Conv(8, 8, (3, 3), (stride, stride), use_bias=False, groups=groups,
                       dilation=(dilation, dilation))
    port.load_state_dict(params_from_jax(params))
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(layers.nhwc_to_nchw(torch.from_numpy(x))).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    _close(got, ref)


def test_avg_pool_layer_norm_and_gelu_are_flax():
    x = _images((2, 7, 7, 4))
    ref = np.asarray(fnn.avg_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME"))
    got = layers.avg_pool_same(layers.nhwc_to_nchw(torch.from_numpy(x)), 3, 2)
    _close(got.permute(0, 2, 3, 1).numpy(), ref)
    jln = fnn.LayerNorm()
    p = jax.device_get(jln.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    tln = layers.LayerNorm(4)
    tln.load_state_dict(params_from_jax(p))
    with torch.no_grad():
        _close(tln(torch.from_numpy(x)).numpy(), np.asarray(jln.apply({"params": p}, x)))
    _close(layers.gelu(torch.from_numpy(x)).numpy(), np.asarray(fnn.gelu(jnp.asarray(x))))
    _close(layers.hard_swish(torch.from_numpy(x)).numpy(),
           np.asarray(jmob._hard_swish(jnp.asarray(x))))


def test_converter_round_trip_keeps_3d_kernels_in_flax_layout():
    """The attention's [d, H, hd] and [H, hd, d] kernels pass through the
    converter, the wire vector and back, bit for bit, in JAX's flat order."""
    _, params, port, _ = _pair("text_classifier")
    state = port.state_dict()
    q = state["block_0.MultiHeadDotProductAttention_0.query.weight"]
    assert q.shape == (32, 4, 8)
    assert state["block_0.MultiHeadDotProductAttention_0.out.weight"].shape == (4, 8, 32)
    back = _leaves(params_to_jax(port))
    ref = _leaves(params)
    assert back.keys() == ref.keys()
    for k in ref:
        assert np.array_equal(np.asarray(back[k]), np.asarray(ref[k])), k
    vec = wire_vector(state)
    assert np.array_equal(vec.numpy(), np.asarray(jax_flatten(params)[0]))
    again = state_from_wire_vector(vec, state)
    assert all(torch.equal(again[k], state[k]) for k in state)


def test_lstm_state_dict_holds_flax_leaves():
    _, params, port, _ = _pair("rnn")
    names = set(port.state_dict())
    assert "LSTMCell_0.if.weight" in names and "LSTMCell_0.if.bias" not in names
    assert "LSTMCell_1.hg.bias" in names and "Embed_0.embedding" in names
    assert len(names) == len(_leaves(params))


def test_flax_init_draws_the_new_leaves():
    """The draws' deterministic properties: orthogonal recurrent kernels,
    lecun_normal's truncation at two widened standard deviations, the
    alphas at 1e-3, norm scales 1, biases 0."""
    gen = torch.Generator().manual_seed(0)
    rnn = layers.flax_init_(trnn.RNNOriginalFedAvg(hidden_size=16), gen)
    w = rnn.LSTMCell_0.hf.weight.detach()
    assert torch.allclose(w @ w.T, torch.eye(16), atol=1e-5)
    bound = 2 * (1 / 8) ** 0.5 / 0.87962566103423978
    assert rnn.LSTMCell_0.ii.weight.abs().max() <= bound and rnn.LSTMCell_0.hi.bias.eq(0).all()
    net = layers.flax_init_(tdarts.DARTSNetwork(width=8, layers=1, steps=2), gen)
    assert net.arch.eq(1e-3).all()
    tc = layers.flax_init_(ttc.distilbert_shape(5, **TC_CFG), gen)
    q = tc.block_0.MultiHeadDotProductAttention_0.query
    assert q.weight.abs().max() <= 2 * (1 / 32) ** 0.5 / 0.87962566103423978
    assert tc.final_norm.scale.eq(1).all() and q.bias.eq(0).all()


def test_derive_genotype_ties_sort_stably_as_jax():
    alphas = np.full((jdarts.num_edges(3), len(jdarts.OP_NAMES)), 1e-3, np.float32)
    assert tdarts.derive_genotype(alphas) == jdarts.derive_genotype(jnp.asarray(alphas))
    alphas = np.random.default_rng(0).standard_normal(alphas.shape).astype(np.float32)
    alphas[3:5] = alphas[3]  # a tie between two edges of one node
    assert tdarts.derive_genotype(torch.from_numpy(alphas)) == \
        jdarts.derive_genotype(jnp.asarray(alphas))


# --- the hub -----------------------------------------------------------------------------

HUB = [("distilbert", "20news"), ("bert", "agnews"), ("text_classifier", "sst2"),
       ("transformer_cls", "semeval_2010_task8"), ("rnn", "shakespeare"),
       ("rnn_fedavg", "fed_shakespeare"), ("rnn_stackoverflow", "stackoverflow_nwp"),
       ("rnn_nwp", "stackoverflow_nwp"), ("mobilenet", "cifar10"), ("mobilenet_v3", "cifar10"),
       ("efficientnet", "cifar10"), ("efficientnet_lite0", "cifar100"), ("gan", "mnist"),
       ("cgan", "cifar10"), ("dcgan", "mnist"), ("darts", "cifar10"), ("nas", "cifar10"),
       ("fednas", "mnist"), ("unet", "pascal_voc"), ("segnet", "pascal_voc"),
       ("deeplab", "cityscapes"), ("lr", "stackoverflow_lr")]
_OUT_DIM = {"shakespeare": 90, "fed_shakespeare": 90, "stackoverflow_nwp": 10004, "20news": 20,
            "agnews": 4, "sst2": 2, "semeval_2010_task8": 19, "cifar100": 100,
            "pascal_voc": 3, "cityscapes": 3, "stackoverflow_lr": 500}


@pytest.mark.parametrize("name,dataset", HUB)
def test_hub_builds_the_jax_model(name, dataset):
    """``model_hub.create`` builds JAX's model for every vision and text name
    (F1: both ``efficientnet`` names build efficientnet_lite0): the same
    leaves, input spec and dtype, and, from JAX's parameters, the same
    output on a batch of the spec."""
    kw = dict(model=name, dataset=dataset, text_n_layers=2, darts_layers=2)
    dim = _OUT_DIM.get(dataset, 10)
    jm = fedml_tpu.model.create(fedml_tpu.default_config("simulation", **kw), dim)
    tm = fedml_tpu_torch.model.create(fedml_tpu_torch.default_config("simulation", **kw), dim,
                                      device="cpu")
    jparams = jax.device_get(jm.params)
    assert tm.input_shape == tuple(jm.input_shape)
    assert str(tm.input_dtype).split(".")[-1] == jnp.dtype(jm.input_dtype).name
    state = tm.module.state_dict()
    ref_leaves = _leaves(jparams)
    got_leaves = _leaves(params_to_jax(state))
    assert {k: v.shape for k, v in got_leaves.items()} == \
        {k: v.shape for k, v in ref_leaves.items()}
    tm.module.load_state_dict(params_from_jax(jparams))
    shape = (2,) + tuple(jm.input_shape[1:])
    if jm.input_dtype == jnp.int32:
        vocab = (jparams.get("tok_embed") or jparams["Embed_0"])["embedding"].shape[0]
        x = np.random.default_rng(0).integers(0, vocab, shape).astype(np.int32)
    else:
        x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jm.apply(jparams, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.module(torch.from_numpy(x)).numpy()
    _close(got, ref)


@pytest.mark.parametrize("name", ["llama", "gpt", "transformer"])
def test_hub_refuses_only_the_llm_names(name, tmp_path):
    """The hub builds the LLM names (tests/test_torch_llm_files.py holds them
    to JAX); what it still refuses for them is a JAX orbax checkpoint as
    ``pretrained_path``, which the port cannot read without orbax."""
    (tmp_path / "orbax" / "1").mkdir(parents=True)
    kw = dict(model=name, dataset="shakespeare", vocab_size=96, d_model=32, n_layers=1,
              n_heads=2, n_kv_heads=2, d_ff=64, seq_len=16)
    args = fedml_tpu_torch.default_config("simulation", **kw)
    model = fedml_tpu_torch.model.create(args, 90, device="cpu")
    from fedml_tpu_torch.models.transformer import TransformerLM

    assert isinstance(model.module, TransformerLM)
    args = fedml_tpu_torch.default_config("simulation", pretrained_path=str(tmp_path / "orbax"),
                                          **kw)
    with pytest.raises(ValueError, match="ROADMAP"):
        fedml_tpu_torch.model.create(args, 90, device="cpu")


def test_hub_still_refuses_an_unknown_name():
    args = fedml_tpu_torch.default_config("simulation", model="vgg", dataset="cifar10")
    with pytest.raises(ValueError, match="unknown model"):
        fedml_tpu_torch.model.create(args, 10, device="cpu")


# --- the datasets ------------------------------------------------------------------------

DATASETS = ["shakespeare", "fed_shakespeare", "stackoverflow_nwp", "reddit", "20news", "agnews",
            "sst2", "semeval_2010_task8", "lending_club", "uci", "stackoverflow_lr",
            "pascal_voc", "coco_seg", "cityscapes"]


def _assert_loads_equal(ref, got, ja, ta):
    assert ref[0] == got[0] and ref[1] == got[1] and ref[7] == got[7]
    assert ref[4] == got[4] and ja.output_dim == ta.output_dim
    assert sorted(ref[5]) == sorted(got[5]) and sorted(ref[6]) == sorted(got[6])
    for r_ds, g_ds in [(ref[2], got[2]), (ref[3], got[3])] + \
            [(ref[5][c], got[5][c]) for c in ref[5]] + [(ref[6][c], got[6][c]) for c in ref[6]]:
        for a, b in ((r_ds.x, g_ds.x), (r_ds.y, g_ds.y)):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _load_both(**kw):
    ja = fedml_tpu.default_config("simulation", **kw)
    ta = fedml_tpu_torch.default_config("simulation", using_gpu=False, **kw)
    return jloader.load(ja), tloader.load(ta), ja, ta


@pytest.mark.parametrize("dataset", DATASETS)
def test_data_load_is_bit_equal_to_jax(dataset):
    ref, got, ja, ta = _load_both(dataset=dataset, client_num_in_total=4)
    _assert_loads_equal(ref, got, ja, ta)


def _write_npz(path, kind):
    rng = np.random.default_rng(0)
    if kind == "text":
        x = rng.integers(0, 90, (30, 80))
        np.savez(path, x_train=x[:20], y_train=x[:20], x_test=x[20:], y_test=x[20:])
    elif kind == "stackoverflow_lr":
        np.savez(path, x_train=rng.random((20, 10000)) < 0.01, y_train=rng.random((20, 500)) < 0.1,
                 x_test=rng.random((8, 10000)) < 0.01, y_test=rng.random((8, 500)) < 0.1)
    else:
        width = {"20news": 128, "lending_club": 90}[kind]
        np.savez(path, x_train=rng.integers(0, 99, (40, width)), y_train=rng.integers(0, 2, 40),
                 x_test=rng.integers(0, 99, (10, width)), y_test=rng.integers(0, 2, 10))


@pytest.mark.parametrize("dataset,kind", [("shakespeare", "text"), ("20news", "20news"),
                                          ("lending_club", "lending_club"),
                                          ("stackoverflow_lr", "stackoverflow_lr")])
def test_data_load_reads_an_npz_as_jax_does(tmp_path, dataset, kind):
    _write_npz(tmp_path / f"{dataset}.npz", kind)
    ref, got, ja, ta = _load_both(dataset=dataset, client_num_in_total=3,
                                  data_cache_dir=str(tmp_path))
    assert got[0] == 20 if kind in ("text", "stackoverflow_lr") else got[0] == 40
    _assert_loads_equal(ref, got, ja, ta)


def _write_csv(root, which):
    rng = np.random.default_rng(0)
    if which == "lending_club":
        (root / "lending_club").mkdir()
        status = ["Fully Paid", "Charged Off", "Current", "Late (31-120 days)", "Default"]
        rows = ["loan_status,issue_d,loan_amnt,int_rate,dti,grade"]
        for i in range(60):
            dti = "" if i % 7 == 0 else f"{rng.uniform(0, 40):.2f}"
            year = 2018 if i % 3 else 2017
            rows.append(f"{status[i % 5]},Mar-{year},{rng.integers(1000, 40000)},"
                        f"{rng.uniform(5, 30):.2f},{dti},{'ABC'[i % 3]}")
        (root / "lending_club" / "loan.csv").write_text("\n".join(rows) + "\n")
    elif which == "susy":
        rows = [",".join([str(int(rng.integers(0, 2)))]
                         + [f"{v:.6f}" for v in rng.normal(0, 1, 18)]) for _ in range(50)]
        (root / "SUSY.csv").write_text("\n".join(rows) + "\n")
    else:
        rows = ['"date","Temperature","Humidity","Light","CO2","HumidityRatio","Occupancy"']
        for i in range(40):
            vals = rng.uniform(0, 500, 5)
            rows.append(f'"{i + 1}","2015-02-04 17:{i:02d}:00",'
                        + ",".join(f"{v:.4f}" for v in vals) + f",{int(rng.integers(0, 2))}")
        (root / "uci").mkdir()
        (root / "uci" / "datatraining.txt").write_text("\n".join(rows) + "\n")


@pytest.mark.parametrize("dataset,which", [("lending_club", "lending_club"), ("uci", "susy"),
                                           ("uci", "room_occupancy")])
def test_data_load_reads_the_reference_csvs_as_jax_does(tmp_path, dataset, which):
    _write_csv(tmp_path, which)
    ref, got, ja, ta = _load_both(dataset=dataset, client_num_in_total=2,
                                  data_cache_dir=str(tmp_path))
    assert got[0] + got[1] == {"lending_club": 40, "susy": 50, "room_occupancy": 40}[which]
    _assert_loads_equal(ref, got, ja, ta)


def _reference_layout(root, dataset):
    d = root / dataset
    d.mkdir()
    touch = {
        "shakespeare": [], "fed_shakespeare": ["shakespeare_train.h5"],
        "stackoverflow_nwp": ["stackoverflow_train.h5"],
        "stackoverflow_lr": ["stackoverflow_train.h5", "stackoverflow.word_count",
                             "stackoverflow.tag_count"],
        "20news": ["20news_data.h5", "20news_partition.h5"],
        "reddit": ["user_0.txt"], "pascal_voc": ["dataset/train.txt"], "cityscapes": [],
        "coco_seg": ["2017/annotations/instances_train2017.json"],
    }[dataset]
    dirs = {"shakespeare": ["train"], "pascal_voc": ["dataset/img", "dataset/cls"],
            "cityscapes": ["leftImg8bit/train", "gtFine"], "coco_seg": ["2017/train2017"]}
    for sub in dirs.get(dataset, []):
        (d / sub).mkdir(parents=True)
    for f in touch:
        (d / f).parent.mkdir(parents=True, exist_ok=True)
        (d / f).write_bytes(b"")


class _Surrogate(Exception):
    """Raised by the stubbed surrogate loaders: the loader fell back."""


def _load_outcome(load, args):
    try:
        load(args)
    except _Surrogate:
        return "surrogate"
    except Exception as e:  # noqa: BLE001 - the exception type is what is compared
        return type(e).__name__
    return "read"


@pytest.mark.parametrize("dataset", ["shakespeare", "fed_shakespeare", "stackoverflow_nwp",
                                     "stackoverflow_lr", "20news", "reddit", "pascal_voc",
                                     "cityscapes", "coco_seg"])
def test_reference_format_files_raise_where_jax_reads_them(tmp_path, dataset, monkeypatch):
    """Where JAX's probe finds LEAF/TFF/FedNLP/segmentation files the port
    reads them too (tests/test_torch_data_formats.py holds the readers to
    JAX's). On these empty files each package does what the other does:
    both log the fallback to the surrogate, or both raise the same error.
    The surrogates are stubbed with a sentinel in both packages."""
    import fedml_tpu.simulation.sp.fedseg as jfedseg
    import fedml_tpu_torch.simulation.sp.fedseg as tfedseg

    _reference_layout(tmp_path, dataset)
    assert jformats.detect_format_files(dataset, str(tmp_path)) == dataset

    def sentinel(*a, **k):
        raise _Surrogate

    for mod in (jloader, tloader):
        for name in ("load_text_dataset", "load_text_classification_dataset",
                     "load_stackoverflow_lr"):
            monkeypatch.setattr(mod, name, sentinel)
    for mod in (jfedseg, tfedseg):
        monkeypatch.setattr(mod, "make_segmentation_data", sentinel)
    kw = dict(dataset=dataset, data_cache_dir=str(tmp_path))
    ref = _load_outcome(jloader.load, fedml_tpu.default_config("simulation", **kw))
    got = _load_outcome(tloader.load, fedml_tpu_torch.default_config("simulation", **kw))
    assert got == ref


def test_r13_lr_on_a_table_sizes_its_input_from_the_data():
    """JAX's hub sizes ``lr`` on lending_club from the 28x28x1 default and
    fails at its first step; the port's loader records the table's width."""
    kw = dict(model="lr", dataset="lending_club", client_num_in_total=4, client_num_per_round=2,
              comm_round=1, batch_size=64, frequency_of_the_test=1)
    jargs = fedml_tpu.init(fedml_tpu.default_config("simulation", **kw))
    jdata, jdim = fedml_tpu.data.load(jargs)
    with pytest.raises(Exception, match="shape"):
        fedml_tpu.FedMLRunner(jargs, "cpu", jdata, fedml_tpu.model.create(jargs, jdim)).run()
    targs = fedml_tpu_torch.init(fedml_tpu_torch.default_config("simulation", using_gpu=False,
                                                                **kw))
    tdata, tdim = fedml_tpu_torch.data.load(targs)
    assert targs.input_shape == (1, 90)
    tmodel = fedml_tpu_torch.model.create(targs, tdim, device="cpu")
    out = fedml_tpu_torch.FedMLRunner(targs, torch.device("cpu"), tdata, tmodel).run()
    assert np.isfinite(out["test_loss"]) and out["test_acc"] > 0.5
