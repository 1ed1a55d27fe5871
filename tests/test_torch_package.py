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

import numpy as np
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


def test_serving_modules_load_no_jax_or_fedml_tpu():
    """The serving path on its own: importing the serving package and the
    generation module leaves no jax or fedml_tpu module loaded."""
    code = (
        "import sys\n"
        "import fedml_tpu_torch.serving, fedml_tpu_torch.train.llm.generation\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'fedml_tpu'))\n"
        "print('BAD', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def _tiny_lm(**over):
    from fedml_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    cfg = TransformerConfig(**{**dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                                      n_kv_heads=2, d_ff=64, max_seq_len=32, remat=False,
                                      lora_rank=2), **over})
    model = TransformerLM(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
    return cfg, model


def test_serving_entry_points_raise_without_cuda(no_cuda):
    """generate, generate_batch, decode_model, LLMPredictor, TorchPredictor
    and both engines default to CUDA and raise without it; given "cpu" they
    run."""
    from fedml_tpu_torch.serving import (ContinuousBatchingEngine, LLMPredictor,
                                         PagedContinuousBatchingEngine, TorchPredictor)
    from fedml_tpu_torch.train.llm import generation as tg
    from fedml_tpu_torch.train.llm.tokenizer import train_bpe

    cfg, model = _tiny_lm()
    tok = train_bpe(["a b c"], vocab_size=260)
    calls = [lambda **kw: tg.generate(model, cfg, [[1, 2]], 2, **kw),
             lambda **kw: tg.generate_batch(model, cfg, [[1, 2]], 2, **kw),
             lambda **kw: tg.decode_model(cfg, model, **kw),
             lambda **kw: LLMPredictor(model, cfg, tok, **kw),
             lambda **kw: ContinuousBatchingEngine(model, cfg, num_slots=1, **kw),
             lambda **kw: PagedContinuousBatchingEngine(model, cfg, num_slots=1, **kw),
             lambda **kw: TorchPredictor(lambda p, x: x, None, **kw)]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        made = call(device="cpu")
        engine = getattr(made, "engine", made)
        if hasattr(engine, "shutdown"):
            engine.shutdown()


def test_load_time_cast_equals_the_per_call_cast_bit_for_bit():
    """The decode model holds dense weights and LoRA factors in bf16, cast
    once at load (norm scales stay f32); the training model casts its f32
    weights on every call. f32 -> bf16 rounds to nearest even either way, so
    the weights and the logits are bit-identical."""
    from fedml_tpu_torch.train.llm.generation import decode_model

    cfg, train = _tiny_lm(dtype=torch.bfloat16)
    dec = decode_model(cfg, train, device="cpu")
    for (name, p), (_, q) in zip(train.named_parameters(), dec.named_parameters()):
        if name.endswith("scale"):
            assert q.dtype == torch.float32 and torch.equal(p, q), name
        else:
            assert q.dtype == torch.bfloat16, name
            assert torch.equal(q.view(torch.int16), p.to(torch.bfloat16).view(torch.int16)), name
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 12)))
    with torch.no_grad():
        assert torch.equal(train(toks), dec(toks))


FEDAVG_MODULES = (
    "fedml_tpu_torch.runner", "fedml_tpu_torch.arguments", "fedml_tpu_torch.constants",
    "fedml_tpu_torch.data", "fedml_tpu_torch.data.data_loader", "fedml_tpu_torch.data.sources",
    "fedml_tpu_torch.core.data.noniid_partition", "fedml_tpu_torch.models.model_hub",
    "fedml_tpu_torch.models.resnet", "fedml_tpu_torch.models.cnn", "fedml_tpu_torch.models.linear",
    "fedml_tpu_torch.models.layers", "fedml_tpu_torch.utils.pytree",
    "fedml_tpu_torch.ml.trainer.local_sgd", "fedml_tpu_torch.ml.trainer.classification_trainer",
    "fedml_tpu_torch.ml.trainer.trainer_creator", "fedml_tpu_torch.ml.aggregator",
    "fedml_tpu_torch.core.aggregation.bucketed", "fedml_tpu_torch.core.aggregation.agg_operator",
    "fedml_tpu_torch.core.aggregation.server_optimizer", "fedml_tpu_torch.core.engine",
    "fedml_tpu_torch.core.alg_frame.server_aggregator", "fedml_tpu_torch.core.alg_frame.context",
    "fedml_tpu_torch.simulation.simulator", "fedml_tpu_torch.simulation.sp.fedavg_api",
    "fedml_tpu_torch.tools.profile_fedavg_round")


def test_fedavg_modules_load_no_jax_or_fedml_tpu():
    """The sp FedAvg path on its own: importing each of its modules leaves no
    jax or fedml_tpu module loaded, and builds no kernel."""
    code = (
        "import importlib, sys\n"
        f"for m in {FEDAVG_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from fedml_tpu_torch.ops import _build\n"
        "assert _build.kernels.cache_info().currsize == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'fedml_tpu'))\n"
        "print('BAD', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_fedavg_entry_points_raise_without_cuda(no_cuda):
    """get_device, model.create and run_simulation default to CUDA and
    raise without it; using_gpu=False (or device="cpu") runs on the CPU."""
    args = fedml_tpu_torch.default_config("simulation", data_cache_dir="", comm_round=1,
                                          client_num_in_total=2, client_num_per_round=2,
                                          batch_size=200)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fedml_tpu_torch.get_device(args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fedml_tpu_torch.model.create(args, 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fedml_tpu_torch.run_simulation(args=args)
    assert fedml_tpu_torch.model.create(args, 10, device="cpu").device.type == "cpu"
    args.using_gpu = False
    assert fedml_tpu_torch.get_device(args) == torch.device("cpu")
    out = fedml_tpu_torch.run_simulation(args=args)
    assert out["round"] == 0 and np.isfinite(out["test_loss"])


CROSS_SILO_MODULES = (
    "fedml_tpu_torch.cross_silo", "fedml_tpu_torch.core.distributed.fedml_comm_manager",
    "fedml_tpu_torch.core.distributed.communication.mqtt_s3.mqtt_s3_comm_manager",
    "fedml_tpu_torch.core.distributed.communication.mqtt_s3.socket_broker",
    "fedml_tpu_torch.core.distributed.communication.codec",
)


def test_cross_silo_modules_load_no_jax_ml_dtypes_or_fedml_tpu():
    """The cross-silo front, the comm manager and the MQTT_S3 backend on
    their own: importing them, and a bf16 payload's round trip through the
    codec, leave no jax, ml_dtypes or fedml_tpu module loaded."""
    code = (
        "import importlib, sys\n"
        f"for m in {CROSS_SILO_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import torch\n"
        "from fedml_tpu_torch.core.distributed.communication import serialization as s\n"
        "t = torch.arange(6.0).reshape(2, 3).bfloat16()\n"
        "assert torch.equal(s.deserialize_pytree(s.serialize_pytree({'w': t}))['w'], t)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', 'fedml_tpu'))\n"
        "print('BAD', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_cross_silo_entry_points_raise_without_cuda(no_cuda):
    """A cross-silo party defaults to CUDA and raises without it; with
    using_gpu=False it is built on the CPU."""
    args = fedml_tpu_torch.default_config("cross_silo", role="server", rank=0,
                                          backend="INMEMORY", dataset="synthetic",
                                          client_num_in_total=2, client_num_per_round=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fedml_tpu_torch.run_cross_silo_server(args)
    args.using_gpu = False
    dataset, output_dim = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.model.create(args, output_dim, device="cpu")
    runner = fedml_tpu_torch.FedMLRunner(args, torch.device("cpu"), dataset, model)
    assert type(runner.runner).__name__ == "FedMLCrossSiloServer"


ASYNC_MODULES = (
    "fedml_tpu_torch.core.resilience.quorum", "fedml_tpu_torch.core.aggregation.async_buffer",
    "fedml_tpu_torch.utils.compression", "fedml_tpu_torch.simulation.vmapped.async_driver",
    "fedml_tpu_torch.simulation.sp.async_fedavg", "fedml_tpu_torch.simulation.sp.hierarchical_fl",
    "fedml_tpu_torch.cross_silo.server.fedml_aggregator",
    "fedml_tpu_torch.cross_silo.server.fedml_server_manager",
    "fedml_tpu_torch.cross_silo.client.fedml_client_master_manager",
)


def test_async_and_compression_modules_load_no_jax_or_fedml_tpu():
    """The async federation, the uplink compressor and the hierarchical
    trainer on their own: importing them, one buffer publish and one
    compressed round trip leave no jax or fedml_tpu module loaded and build
    no kernel."""
    code = (
        "import importlib, sys\n"
        f"for m in {ASYNC_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import torch\n"
        "from fedml_tpu_torch.core.aggregation.async_buffer import AsyncAggBuffer\n"
        "from fedml_tpu_torch.utils.compression import CommCompressor, decompress_comm_payload\n"
        "buf = AsyncAggBuffer(publish_k=2)\n"
        "for r in range(2):\n"
        "    buf.submit(r, {'w': torch.ones(3) * r}, 1.0, 0)\n"
        "assert torch.equal(buf.publish()['w'], torch.full((3,), 0.5))\n"
        "t = {'w': torch.arange(6.0)}\n"
        "c = CommCompressor('eftopk', ratio=1.0)\n"
        "assert torch.equal(decompress_comm_payload(c.compress_tree(t))['w'], t['w'])\n"
        "from fedml_tpu_torch.ops import _build\n"
        "assert _build.kernels.cache_info().currsize == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'fedml_tpu'))\n"
        "print('BAD', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


RESILIENCE_MODULES = (
    "fedml_tpu_torch.core.resilience", "fedml_tpu_torch.core.resilience.round_state",
    "fedml_tpu_torch.core.telemetry.health", "fedml_tpu_torch.core.telemetry.fleet", "fedml_tpu_torch.utils.checkpoint",
    "fedml_tpu_torch.tools.resilience_drill",
)


def test_resilience_modules_load_no_jax_or_fedml_tpu(tmp_path):
    """Durable round state, the fleet view and the drill tool on their own:
    importing them, one async round-state save and its resume leave no jax
    or fedml_tpu module loaded and build no kernel."""
    code = (
        "import importlib, sys\n"
        f"for m in {RESILIENCE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import torch\n"
        "from fedml_tpu_torch.core.resilience import RoundStateStore\n"
        f"store = RoundStateStore({str(tmp_path / 'rs')!r})\n"
        "assert store.save_round(0, {'model': {'w': torch.ones(3)}}, cohort=[1])\n"
        "store.wait()\n"
        "assert torch.equal(store.resume().state['model']['w'], torch.ones(3))\n"
        "from fedml_tpu_torch.ops import _build\n"
        "assert _build.kernels.cache_info().currsize == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'fedml_tpu'))\n"
        "print('BAD', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout, out.stdout


MESSAGE_PLANE_MODULES = (
    "fedml_tpu_torch.core.distributed.communication.trpc",
    "fedml_tpu_torch.core.distributed.communication.trpc.trpc_comm_manager",
    "fedml_tpu_torch.core.distributed.communication.web3",
    "fedml_tpu_torch.core.distributed.communication.grpc.ref_wire",
    "fedml_tpu_torch.core.distributed.communication.mqtt_s3.ref_bucket",
    "fedml_tpu_torch.core.distributed.communication.comm_bench",
    "fedml_tpu_torch.core.distributed.communication.ip_config",
)


def test_message_plane_modules_load_no_grpc_jax_or_ml_dtypes(tmp_path):
    """TRPC, web3, the reference wire and the transport bench on their own:
    importing them, a bf16 frame over a socketpair, a CAS write and read,
    and a pickled ref-wire message leave no grpc, jax, ml_dtypes or
    fedml_tpu module loaded (only grpc/grpc_comm_manager.py imports grpc)."""
    code = (
        "import importlib, socket, sys\n"
        f"for m in {MESSAGE_PLANE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import torch\n"
        "from fedml_tpu_torch.core.distributed.communication.message import Message\n"
        "from fedml_tpu_torch.core.distributed.communication.trpc import trpc_comm_manager as t\n"
        "from fedml_tpu_torch.core.distributed.communication.web3 import LocalCASStore\n"
        "from fedml_tpu_torch.core.distributed.communication.grpc import ref_wire as r\n"
        "w = torch.arange(6.0).reshape(2, 3).bfloat16()\n"
        "m = Message(3, 1, 0)\n"
        "m.add_params(Message.MSG_ARG_KEY_MODEL_PARAMS, {'w': w})\n"
        "a, b = socket.socketpair()\n"
        "h, bufs = t.encode_frame(m)\n"
        "a.sendall(h)\n"
        "[a.sendall(memoryview(x).cast('B')) for x in bufs]\n"
        "assert torch.equal(t.recv_frame(b).get(Message.MSG_ARG_KEY_MODEL_PARAMS)['w'], w)\n"
        f"s = LocalCASStore({str(tmp_path / 'cas')!r})\n"
        "assert torch.equal(s.read_model(s.write_model('k', {'w': w}))['w'], w)\n"
        "back = r.decode_ref_message(r.encode_ref_message(m, 1))\n"
        "assert torch.equal(back.get(Message.MSG_ARG_KEY_MODEL_PARAMS)['w'], w)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('grpc', 'jax', 'jaxlib', 'ml_dtypes', 'fedml_tpu'))\n"
        "print('BAD', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout, out.stdout


@pytest.mark.parametrize("backend", ["TRPC", "GRPC", "MPI", "MQTT_WEB3", "MQTT_THETASTORE"])
def test_cross_silo_entry_points_on_the_new_backends_raise_without_cuda(no_cuda, backend):
    """A cross-silo party over each new backend defaults to CUDA and raises
    before any backend starts."""
    args = fedml_tpu_torch.default_config("cross_silo", role="server", rank=0, backend=backend,
                                          dataset="synthetic", client_num_in_total=2,
                                          client_num_per_round=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fedml_tpu_torch.run_cross_silo_server(args)
