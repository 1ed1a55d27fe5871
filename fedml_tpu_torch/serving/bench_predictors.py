"""Predictor factories for the endpoint-level serving benchmark.

Counterpart of ``fedml_tpu/serving/bench_predictors.py``. Importable by
replica child processes (``python -m fedml_tpu_torch.serving.replica_main
--predictor fedml_tpu_torch.serving.bench_predictors:llm_bench_predictor``)
so an endpoint measurement runs the real deployment topology (gateway ->
subprocess replicas -> KV-cache decode), not an in-process shortcut.
Reference role: the model package a reference replica container would load
(``model_scheduler/device_model_deployment.py``).

Environment: ``FEDML_BENCH_TINY=1`` / ``FEDML_BENCH_FLAGSHIP=1`` pick the
geometry, ``FEDML_BENCH_INT8=1`` serves weight-only int8 (serving/quant.py),
and ``FEDML_REPLICA_PLATFORM=cpu`` serves on the CPU with torch pinned to
one thread. Without it the replica serves on the card, and raises where
there is none.
"""

from __future__ import annotations

import os


def bench_predictor_config(tiny: bool, flagship: bool, tok_vocab: int):
    """Geometry selection for the serving-bench predictor (pure: testable
    without building weights). Flagship keeps the train bench's 32000-entry
    embedding/head (the BPE tokenizer only emits ids < tok_vocab, a valid
    subset) so the parameter count matches the headline model."""
    import torch

    from ..models.transformer import TransformerConfig

    return TransformerConfig(
        vocab_size=32000 if flagship else tok_vocab,
        d_model=64 if tiny else (1024 if flagship else 512),
        n_layers=2 if tiny else (16 if flagship else 8),
        n_heads=4 if tiny else (16 if flagship else 8),
        n_kv_heads=4 if tiny else (16 if flagship else 8),
        d_ff=128 if tiny else (2752 if flagship else 1376),
        max_seq_len=64 if tiny else 256,
        dtype=torch.float32 if tiny else torch.bfloat16,
        remat=False,
        lora_rank=0,
    )


def llm_bench_predictor():
    """Llama-family model + BPE tokenizer, weights drawn from a seeded
    generator on the serving device, warmed up before the replica reports
    ready.

    Three geometries:
      * tiny (FEDML_BENCH_TINY=1): f32, the CPU test harness;
      * default: about 30M parameters;
      * flagship (FEDML_BENCH_FLAGSHIP=1): the train bench's geometry
        (d_model 1024, 16 layers, d_ff 2752, vocab 32000), about 0.5 GB of
        bf16 weights a replica; pair with FEDML_REPLICA_MEM_FRACTION so
        replicas and their KV caches share one card deterministically.
    """
    import torch

    from ..train.llm.generation import decode_model
    from ..train.llm.tokenizer import train_bpe
    from .fedml_predictor import LLMPredictor

    # the card unless the CPU is asked for; decode_model raises where CUDA
    # is asked for and absent
    device = os.environ.get("FEDML_REPLICA_PLATFORM") or "cuda"
    if device == "cpu":
        torch.set_num_threads(1)
    tiny = os.environ.get("FEDML_BENCH_TINY") == "1"
    flagship = (not tiny) and os.environ.get("FEDML_BENCH_FLAGSHIP") == "1"
    tok = train_bpe(
        ["federated benchmark serving endpoint throughput measure " * 4] * 8,
        vocab_size=512,
    )
    cfg = bench_predictor_config(tiny, flagship, tok.vocab_size)
    model = decode_model(cfg, None, device=device)
    model.reset_parameters(torch.Generator(device=model.embed.embedding.device).manual_seed(0))
    if os.environ.get("FEDML_BENCH_INT8") == "1":
        # weight-only int8 serving (quant.py), quantized on the serving
        # device: half the decode bytes of bf16
        from .quant import quantize_model_int8

        cfg, params = quantize_model_int8(cfg, model)
        del model
        model = params
    predictor = LLMPredictor(model, cfg, tok, default_max_new_tokens=16 if tiny else 64,
                             device=device)
    predictor.warmup()
    return predictor
