"""The port's FedAvg models against the JAX package's, on the CPU.

Each JAX model is initialised by flax, carried into the port through
``models/convert.py``, and both run the same inputs (numpy, seeded). The
converter round trip (JAX -> port -> JAX, and through the flat vector) is
bit-exact; the logits agree at f32 within ``rtol=1e-5`` with an absolute
floor of 1e-5 of the logits' largest magnitude (elements near 0 have no
relative scale; measured worst, about 7e-7 of the scale).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models import cnn as jcnn
from fedml_tpu.models import linear as jlinear
from fedml_tpu.models import resnet as jresnet
from fedml_tpu_torch.models import cnn as tcnn
from fedml_tpu_torch.models import layers
from fedml_tpu_torch.models import linear as tlinear
from fedml_tpu_torch.models import resnet as tresnet
from fedml_tpu_torch.models.convert import params_from_jax, params_to_jax
from fedml_tpu_torch.utils.pytree import tree_flatten_to_vector, tree_unflatten_from_vector

RTOL = 1e-5

# name: (JAX module, port module factory, input shape)
MODELS = {
    "lr": (lambda: jlinear.LogisticRegression(10), lambda: tlinear.LogisticRegression(784, 10),
           (4, 28, 28, 1)),
    "two_nn": (lambda: jlinear.TwoNN(num_classes=10), lambda: tlinear.TwoNN(60, num_classes=10),
               (4, 60)),
    "cnn_dropout": (lambda: jcnn.CNNDropOut(), lambda: tcnn.CNNDropOut(), (4, 28, 28, 1)),
    "cnn_cifar": (lambda: jcnn.CNNCifar(), lambda: tcnn.CNNCifar(), (4, 32, 32, 3)),
    "resnet8_w8": (lambda: jresnet.ResNetCifar(depth=8, width=8),
                   lambda: tresnet.ResNetCifar(depth=8, width=8), (4, 32, 32, 3)),
    "resnet20": (lambda: jresnet.resnet20(), lambda: tresnet.resnet20(), (4, 32, 32, 3)),
    # 64x64 so the SAME-padded 7x7 stride-2 stem (2, 3) and max pool (0, 1) run
    "resnet18_gn": (lambda: jresnet.ResNet18GN(num_classes=10),
                    lambda: tresnet.ResNet18GN(num_classes=10), (2, 64, 64, 3)),
}


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    """The JAX module, its flax-initialised params and the input, once per
    process."""
    make_jax, _, shape = MODELS[name]
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jm = make_jax()
    keys = {"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(1)}
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


def _assert_bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        x, y = np.asarray(la[k]), np.asarray(lb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x.view(np.uint32), y.view(np.uint32)), k


def _logits_close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize("name", ["lr", "cnn_cifar", "cnn_dropout", "resnet8_w8", "resnet18_gn"])
def test_converter_round_trip_is_bit_exact(name):
    """JAX init -> port state dict -> flat vector -> state dict -> JAX, bit
    for bit; every port parameter is one JAX leaf, paths one to one."""
    jm, params, port, _ = _pair(name)
    state = port.state_dict()
    assert len(state) == len(_leaves(params))
    _assert_bit_equal(params_to_jax(port), params)
    flat, spec = tree_flatten_to_vector(state)
    assert flat.shape == (sum(v.numel() for v in state.values()),)
    back = tree_unflatten_from_vector(flat, spec)
    _assert_bit_equal(params_to_jax(back), params)


def test_conv_kernel_layout():
    """flax HWIO -> torch OIHW is transpose(3, 2, 0, 1): each output
    channel's [in, kh, kw] block is the JAX kernel's [:, :, in, out]."""
    _, params, port, _ = _pair("resnet8_w8")
    k = params["Conv_0"]["kernel"]
    w = port.Conv_0.weight.detach().numpy()
    assert w.shape == (k.shape[3], k.shape[2], k.shape[0], k.shape[1])
    assert np.array_equal(w[5, 2], k[:, :, 2, 5])


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_logits_match_jax(name):
    jm, params, port, x = _pair(name)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    _logits_close(got, ref)


def test_symmetric_padding_fails_the_comparison(monkeypatch):
    """torch's padding=1 on a 3x3 stride-2 conv pads (1, 1) where SAME pads
    (0, 1): same shapes, other values. The comparison above must refuse it."""
    jm, params, port, x = _pair("resnet8_w8")
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), train=False))
    monkeypatch.setattr(layers, "same_padding",
                        lambda size, kernel, stride: ((kernel - 1) // 2, (kernel - 1) // 2))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    with pytest.raises(AssertionError):
        _logits_close(got, ref)


@pytest.mark.parametrize("size,kernel,stride,want", [
    (32, 3, 2, (0, 1)), (32, 3, 1, (1, 1)), (32, 1, 2, (0, 0)),
    (64, 7, 2, (2, 3)), (224, 7, 2, (2, 3)), (33, 3, 2, (1, 1))])
def test_same_padding_is_flax_same(size, kernel, stride, want):
    assert layers.same_padding(size, kernel, stride) == want


def test_group_norm_uses_flax_epsilon():
    """flax GroupNorm's epsilon (1e-6), not torch's (1e-5): visible on a
    channel group of small variance."""
    import flax.linen as nn

    x = (np.random.default_rng(3).standard_normal((2, 4, 4, 8)) * 1e-3).astype(np.float32)
    jm = nn.GroupNorm(num_groups=2)
    p = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    ref = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    gn = layers.GroupNorm(2, 8)
    gn.load_state_dict(params_from_jax(p))
    with torch.no_grad():
        got = gn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    torch_eps = torch.nn.functional.group_norm(torch.from_numpy(x).permute(0, 3, 1, 2), 2, eps=1e-5)
    assert not np.allclose(torch_eps.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-4, atol=1e-5)


def test_flax_style_init_statistics():
    """The port draws kernels as flax's lecun_normal (std sqrt(1/fan_in),
    truncated at 2 std), biases 0, norm scales 1."""
    port = tresnet.resnet20()
    layers.flax_init_(port, torch.Generator().manual_seed(0))
    w = port.BasicBlock_8.Conv_1.weight.detach()
    fan_in = w[0].numel()
    assert abs(w.std().item() * np.sqrt(fan_in) - 1.0) < 0.05
    assert w.abs().max().item() <= 2 * np.sqrt(1.0 / fan_in) / 0.87962566103423978 + 1e-6
    assert torch.equal(port.GroupNorm_0.scale, torch.ones(16))
    assert torch.equal(port.Dense_0.bias, torch.zeros(10))
