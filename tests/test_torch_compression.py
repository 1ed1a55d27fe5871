"""The port's update compression (``fedml_tpu_torch/utils/compression.py``)
against the JAX package's, on the CPU.

Tolerances:

- top-k and error-feedback top-k on tie-free seeded vectors: the same
  values (gathered, so bit-equal) and the same index sets, in the same
  order of decreasing magnitude, as JAX's; the eftopk residual after three
  steps within 1e-6 of JAX's, relative to its scale (one f32 add a step);
- naive quantization: the same quantization levels as JAX's, the values
  within 1e-6 of JAX's relative to the vector's scale (the norm's f32
  summation order);
- QSGD: the draws cannot match JAX's PRNG, so its statistics are held: the
  unbiased mean of 256 draws within 15% (mean absolute error over mean
  magnitude, Monte Carlo error only), the biased variant exactly the
  variance-bound factor times the unbiased one for the same generator
  state;
- a round trip at ratio 1.0 bit-exact.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.utils import compression as jc
from fedml_tpu_torch.core import telemetry as tel
from fedml_tpu_torch.core.engine import compress_upload, decompress_arrival
from fedml_tpu_torch.utils import compression as tc


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vec(seed, n):
    """A tie-free seeded f32 vector (distinct magnitudes)."""
    x = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    assert len(np.unique(np.abs(x))) == n
    return x


def _model_tree(seed=11):
    """A state dict whose order is also flax's (keys sorted), so both
    packages flatten it to the same vector."""
    rng = np.random.default_rng(seed)
    return {"a_w": rng.normal(size=(6, 4)).astype(np.float32),
            "b_b": rng.normal(size=(4,)).astype(np.float32),
            "c_out": rng.normal(size=(4, 2)).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


# --- the functional kernels against JAX ------------------------------------------

@pytest.mark.parametrize("n,k", [(5, 2), (64, 7), (1000, 50), (257, 257)])
def test_topk_matches_jax(n, k):
    x = _vec(n, n)
    values, idx = tc.topk_compress(torch.from_numpy(x), k)
    jv, ji = jc.topk_compress(jnp.asarray(x), k)
    assert idx.tolist() == np.asarray(ji).tolist()
    assert np.array_equal(values.numpy(), np.asarray(jv))
    dense = tc.topk_decompress(values, idx, n)
    assert np.array_equal(dense.numpy(), np.asarray(jc.topk_decompress(jv, ji, n)))


def test_topk_keeps_largest():
    x = torch.tensor([0.1, -5.0, 0.2, 3.0, -0.05])
    values, idx = tc.topk_compress(x, 2)
    assert set(idx.tolist()) == {1, 3}
    assert tc.topk_decompress(values, idx, 5).tolist() == [0, -5.0, 0, 3.0, 0]


def test_ef_topk_three_steps_match_jax():
    """Three error-feedback steps on fresh inputs: each step's index set and
    values equal JAX's, the residual within 1e-6 of its scale."""
    n, k = 200, 20
    res_t = torch.zeros(n)
    res_j = jnp.zeros(n)
    for step in range(3):
        x = _vec(100 + step, n)
        (vt, it), res_t = tc.ef_topk_step((res_t, torch.from_numpy(x)), k)
        (vj, ij), res_j = jc.ef_topk_step((res_j, jnp.asarray(x)), k)
        assert it.tolist() == np.asarray(ij).tolist(), step
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-6)
        rj = np.asarray(res_j)
        assert np.abs(res_t.numpy() - rj).max() <= 1e-6 * np.abs(rj).max()
        assert np.count_nonzero(res_t.numpy()) == n - k


@pytest.mark.parametrize("s", [1, 15, 127, 255])
def test_naive_quantize_matches_jax(s):
    x = _vec(7, 300)
    got = tc.naive_quantize(torch.from_numpy(x), s).numpy()
    ref = np.asarray(jc.naive_quantize(jnp.asarray(x), s))
    norm = np.linalg.norm(x.astype(np.float64))
    assert np.array_equal(np.rint(np.abs(got) * s / norm), np.rint(np.abs(ref) * s / norm))
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    assert float(np.abs(got - x).max()) <= norm / s + 1e-6


def test_qsgd_unbiased_in_expectation():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=64).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    outs = torch.stack([tc.qsgd_quantize(gen, x, 4, False) for _ in range(256)])
    err = float((outs.mean(0) - x).abs().mean() / x.abs().mean())
    assert err < 0.15  # stochastic rounding is unbiased; MC error only


def test_qsgd_biased_applies_variance_bound_scale():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=64).astype(np.float32))
    unb = tc.qsgd_quantize(torch.Generator().manual_seed(3), x, 4, False)
    b = tc.qsgd_quantize(torch.Generator().manual_seed(3), x, 4, True)
    scale = 1.0 / (1.0 + min(64 / 16, 8 / 4))
    np.testing.assert_allclose(b.numpy(), unb.numpy() * scale, rtol=1e-6)


def test_tree_topk_matches_jax():
    tree = {"a": _vec(2, 10), "b": _vec(3, 12).reshape(3, 4)}
    comp = tc.tree_topk_compress(_t(tree), ratio=0.5)
    jcomp = jc.tree_topk_compress({k: jnp.asarray(v) for k, v in tree.items()}, ratio=0.5)
    for name in tree:
        assert comp[name][1].tolist() == np.asarray(jcomp[name][1]).tolist()
    back = tc.tree_topk_decompress(comp, _t(tree))
    jback = jc.tree_topk_decompress(jcomp, tree)
    for name in tree:
        assert back[name].shape == tree[name].shape
        assert np.array_equal(back[name].numpy(), np.asarray(jback[name]))


# --- the registry facades ------------------------------------------------------------

def test_registry_and_facades():
    assert set(tc.compressors) == set(jc.compressors) == {"no", "topk", "eftopk", "quantize", "qsgd"}
    c = tc.TopKCompressor()
    x = np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32)
    _, idx, values = c.compress(x, name="w", ratio=0.25)
    dense = c.decompress_new(values, idx, name="w")
    assert dense.shape == (4, 8) and int((dense != 0).sum()) == 8
    ef = tc.EFTopKCompressor()
    g = np.array([1.0, 0.5, 0.4, 0.3], dtype=np.float32)
    assert ef.compress(g, name="g", ratio=0.25)[1].tolist() == [0]
    _, idx2, v2 = ef.compress(g, name="g", ratio=0.25)
    assert idx2.tolist() in ([0], [1]) and float(v2.abs()[0]) >= 0.99
    assert torch.equal(tc.QuantizationCompressor().compress(x, quantize_level=32), torch.from_numpy(x))
    q1 = tc.QSGDCompressor(seed=5).compress(x, quantize_level=4)
    q2 = tc.QSGDCompressor(seed=5).compress(x, quantize_level=4)
    assert torch.equal(q1, q2)  # a seeded generator: the same draws


def test_secagg_support_is_bit_for_bit_jax():
    for nonce, size, ratio in [(0, 100, 0.1), (2**40 + 7, 855770, 0.05), (-3, 10, 1.0)]:
        assert np.array_equal(tc.secagg_support(nonce, size, ratio),
                              jc.secagg_support(nonce, size, ratio))


# --- the comm boundary ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["eftopk", "topk"])
def test_comm_full_ratio_roundtrip_is_exact(kind):
    tree = _t(_model_tree())
    c = tc.CommCompressor(kind, ratio=1.0)
    for _ in range(2):  # the eftopk residual stays zero
        payload = c.compress_tree(tree)
        assert tc.is_comm_payload(payload) and payload["kind"] == kind
        back = tc.decompress_comm_payload(payload)
        assert list(back) == list(tree)
        assert all(torch.equal(back[k], tree[k]) for k in tree)


@pytest.mark.parametrize("kind,ratio", [("topk", 0.25), ("eftopk", 0.1)])
def test_comm_sparse_payload_matches_jax(kind, ratio):
    """The whole model as one vector: the same kept coordinates and values
    as the JAX package's compressor, indexes as int32."""
    tree = _model_tree()
    size = sum(v.size for v in tree.values())
    payload = tc.CommCompressor(kind, ratio=ratio).compress_tree(_t(tree))
    jpayload = jc.CommCompressor(kind, ratio=ratio).compress_tree(tree)
    assert len(payload["values"]) == int(np.ceil(size * ratio)) == len(jpayload["values"])
    assert payload["indexes"].dtype == torch.int32
    assert payload["indexes"].tolist() == jpayload["indexes"].tolist()
    assert np.array_equal(payload["values"].numpy(), jpayload["values"])
    assert tc.payload_nbytes(payload) == jpayload["values"].nbytes + jpayload["indexes"].nbytes
    back = tc.decompress_comm_payload(payload)
    jback = jc.decompress_comm_payload(jpayload)
    for name in tree:
        assert np.array_equal(back[name].numpy(), np.asarray(jback[name]))


def test_comm_eftopk_residual_recovers_dropped_mass():
    c = tc.CommCompressor("eftopk", ratio=0.25)  # k=1
    tree = {"w": torch.tensor([1.0, 0.9, 0.0, 0.0])}
    assert c.compress_tree(tree)["indexes"].tolist() == [0]
    second = c.compress_tree(tree)  # residual 0.9 + fresh 0.9 beats fresh 1.0
    assert second["indexes"].tolist() == [1]
    assert float(second["values"][0]) == pytest.approx(1.8)


@pytest.mark.parametrize("kind", ["quantize", "qsgd"])
def test_comm_dense_kinds_bounded_error(kind):
    tree = _t(_model_tree())
    payload = tc.CommCompressor(kind, quantize_level=8, seed=0).compress_tree(tree)
    assert "dense" in payload and "values" not in payload
    back = tc.decompress_comm_payload(payload)
    for name, orig in tree.items():
        assert back[name].shape == orig.shape and back[name].dtype == torch.float32
        assert float((back[name] - orig).abs().max()) < 0.5
    if kind == "quantize":
        ref = jc.decompress_comm_payload(jc.CommCompressor(kind, quantize_level=8).compress_tree(
            _model_tree()))
        for name in tree:
            assert np.abs(back[name].numpy() - np.asarray(ref[name])).max() <= 1e-6


def test_comm_compressor_args_and_payload_checks():
    with pytest.raises(ValueError, match="unknown comm compressor"):
        tc.CommCompressor("gzip")
    assert tc.make_comm_compressor(types.SimpleNamespace()) is None
    assert tc.make_comm_compressor(types.SimpleNamespace(comm_compressor="no")) is None
    assert tc.make_comm_compressor(types.SimpleNamespace(comm_compressor="none")) is None
    c = tc.make_comm_compressor(types.SimpleNamespace(
        comm_compressor="EFTopK", comm_compressor_ratio=0.1,
        comm_compressor_level=6, comm_compressor_seed=3))
    assert c.kind == "eftopk" and c.ratio == 0.1 and c.quantize_level == 6
    assert not tc.is_comm_payload(_t(_model_tree()))
    assert not tc.is_comm_payload({"kind": "topk"})
    assert not tc.is_comm_payload(None)


def test_compress_upload_and_decompress_arrival_spans():
    """The engine's boundaries: identity without a compressor or for a plain
    state dict; otherwise one client.compress and one server.decompress
    span."""
    tree = _t(_model_tree())
    assert compress_upload(None, tree) is tree
    assert decompress_arrival(tree, 1) is tree
    since = max((r["seq"] for r in tel.snapshot()["spans"]), default=0)
    back = decompress_arrival(compress_upload(tc.CommCompressor("eftopk", 1.0), tree), 3)
    assert all(torch.equal(back[k], tree[k]) for k in tree)
    spans = [r for r in tel.snapshot()["spans"] if r["seq"] > since]
    assert [r["name"] for r in spans] == ["client.compress", "server.decompress"]
    assert spans[0]["attrs"]["kind"] == "eftopk" and spans[1]["attrs"]["sender"] == 3
