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
    """Three CUDA kernels with a plain C interface; one binding file is the
    only source that includes PyTorch's headers; the build dir is ignored."""
    for src in _build.KERNEL_SOURCES:
        text = (_build.CSRC / src).read_text()
        assert "torch/extension.h" not in text and 'extern "C"' in text
        assert "Replaces: fedml_tpu/ops/flash_attention.py:" in text
    assert "torch/extension.h" in (_build.CSRC / _build.BINDING_SOURCE).read_text()
    assert "sm_90a" in " ".join(_build.CUDA_FLAGS)
    assert _build.BUILD_DIR == PKG / "ops" / "_build"
    assert "fedml_tpu_torch/ops/_build/" in (ROOT / ".gitignore").read_text().splitlines()


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
