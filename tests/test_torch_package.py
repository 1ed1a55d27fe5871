"""fedml_tpu_torch as a package: import hygiene, devices, kernel sources.

The port imports torch and never jax or fedml_tpu; its entry points run on
CUDA unless the caller asks for the CPU, and raise when CUDA is absent.
"""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import fedml_tpu_torch
from fedml_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "fedml_tpu_torch"


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)], "fedml_tpu_torch."))


def test_import_loads_no_jax_or_fedml_tpu():
    """In a fresh interpreter, the package and every submodule import without
    pulling jax or any fedml_tpu module into sys.modules."""
    code = (
        "import importlib, sys\n"
        "import fedml_tpu_torch\n"
        f"for m in {_submodules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'fedml_tpu' or m.startswith('fedml_tpu.'))\n"
        "print('BAD', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_sources_name_no_jax_import():
    pattern = re.compile(r"^\s*(import jax|from jax)|fedml_tpu\.", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert not offenders
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert not pattern.search(smoke)


def test_importing_builds_nothing():
    """The package imports every module without touching the kernels' build."""
    assert _build.kernels.cache_info().currsize == 0


def test_kernel_sources_and_build_dir():
    """Three CUDA kernels with a plain C interface, built by nvcc alone: no
    source includes PyTorch's headers, ptxas reports registers and spills;
    the build dir is ignored."""
    for src in _build.KERNEL_SOURCES:
        text = (_build.CSRC / src).read_text()
        assert 'extern "C"' in text
        assert "Replaces: fedml_tpu/ops/flash_attention.py:" in text
    for path in _build.CSRC.iterdir():
        assert path.suffix in (".cu", ".cuh"), path.name
        assert "torch/" not in path.read_text(), path.name
    assert "sm_90a" in " ".join(_build.CUDA_FLAGS)
    assert " -Xptxas -v" in " " + " ".join(_build.CUDA_FLAGS)
    assert not hasattr(_build, "build_route") and not hasattr(_build, "_load_extension")
    assert _build.BUILD_DIR == PKG / "ops" / "_build"
    assert "fedml_tpu_torch/ops/_build/" in (ROOT / ".gitignore").read_text().splitlines()


def test_sources_count_launches_by_design():
    """Each source counts its launches by design and exports the counts,
    indexed as _build.DESIGNS names them: every kernel has a SIMT (f32) and a
    wgmma/TMA (bf16) design."""
    common = (_build.CSRC / "flash_common.cuh").read_text()
    assert "enum Design { kSimtF32Fma = 0, kSm90WgmmaTma = 1, kDesigns = 2 };" in common
    assert _build.DESIGNS == ("simt_f32_fma", "sm90_wgmma_tma")
    for src, kernel in zip(_build.KERNEL_SOURCES, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")):
        text = (_build.CSRC / src).read_text()
        assert f'extern "C" long long fedml_{kernel}_launches(int design)' in text
        assert "return counted(kSimtF32Fma," in text
        assert "return counted(kSm90WgmmaTma," in text


@pytest.mark.parametrize("causal", [True, False])
def test_kernel_work_counts(causal):
    """The operations and bytes a bound is computed from: 2*D operations per
    (q, k) product (2, 3 and 4 products), over T(T+1)/2 pairs a head when
    causal; each input read and each output written once."""
    from fedml_tpu_torch.tools.compare_kernels import work

    b, t, hq, hkv, d, esize = 2, 8, 4, 2, 64, 2
    pairs = b * hq * (t * (t + 1) // 2 if causal else t * t)
    q_bytes, kv_bytes, row_bytes = b * hq * t * d * esize, b * hkv * t * d * esize, b * hq * t * 4
    assert work("flash_fwd", b, t, hq, hkv, d, esize, causal) == (
        4 * d * pairs, 2 * q_bytes + 2 * kv_bytes + row_bytes)  # q, k, v -> o, lse
    assert work("flash_bwd_dq", b, t, hq, hkv, d, esize, causal) == (
        6 * d * pairs, 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes)  # q, k, v, dO, lse, delta -> dq
    assert work("flash_bwd_dkv", b, t, hq, hkv, d, esize, causal) == (
        8 * d * pairs, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes)  # ... -> dk, dv


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fedml_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError):
        fedml_tpu_torch.get_device(SimpleNamespace(gpu_id=0))
    assert fedml_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    assert fedml_tpu_torch.get_device(SimpleNamespace(using_gpu=False)) == torch.device("cpu")


def test_trainers_default_to_cuda(no_cuda, tmp_path):
    from fedml_tpu_torch.train.llm.configurations import (DatasetArguments,
                                                          ExperimentArguments, ModelArguments)
    from fedml_tpu_torch.train.llm.fed_llm_trainer import LLMClientTrainer
    from fedml_tpu_torch.train.llm.llm_trainer import LLMTrainer

    geom = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2, d_ff=64,
                seq_len=8, lora_rank=2, remat=False)
    exp = ExperimentArguments(output_dir=str(tmp_path), max_steps=1, per_device_batch_size=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMTrainer(ModelArguments(**geom), DatasetArguments(), exp)
    args = SimpleNamespace(output_dir=str(tmp_path), **geom)
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMClientTrainer(args)
    trainer = LLMTrainer(ModelArguments(**geom), DatasetArguments(), exp, device="cpu")
    assert trainer.device.type == "cpu"
    assert LLMClientTrainer(args, device="cpu").llm.model.embed.embedding.device.type == "cpu"


def test_default_output_dir_is_under_the_callers_temp_dir(monkeypatch, tmp_path):
    """Callers that name no output_dir write under their own temp dir."""
    import tempfile

    from fedml_tpu_torch.train.llm.configurations import ExperimentArguments

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert ExperimentArguments().output_dir == str(tmp_path / "fedml_tpu_llm")
    assert ExperimentArguments.from_args(SimpleNamespace()).output_dir.startswith(str(tmp_path))
