"""User-facing predictor contract for model serving.

Counterpart of ``fedml_tpu/serving/fedml_predictor.py``: subclasses must
implement predict() (or async_predict); ready() gates the readiness probe.
``TorchPredictor`` serves a plain forward function over JSON (the JAX
package's ``JaxPredictor``), and ``LLMPredictor`` serves text generation
over the KV-cache decode path, optionally through a continuous-batching
engine.
"""

from __future__ import annotations

import abc
import os
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..device import resolve_device


class FedMLPredictor(abc.ABC):
    def __init__(self):
        if type(self).predict is FedMLPredictor.predict and type(self).async_predict is FedMLPredictor.async_predict:
            raise NotImplementedError("At least one of the predict methods must be implemented.")

    def predict(self, *args, **kwargs):
        raise NotImplementedError

    async def async_predict(self, *args, **kwargs):
        raise NotImplementedError

    def ready(self) -> bool:
        return True


class TorchPredictor(FedMLPredictor):
    """Serve a forward fn over JSON: {"inputs": [[...]]} -> {"outputs": ...}.
    ``forward_fn(params, x)`` gets the inputs as an f32 tensor on ``device``
    and runs under ``torch.inference_mode()``."""

    def __init__(self, forward_fn: Callable, params: Any, preprocess: Optional[Callable] = None,
                 postprocess: Optional[Callable] = None, device="cuda"):
        self._fn = forward_fn
        self._params = params
        self._pre = preprocess
        self._post = postprocess
        self._dev = resolve_device(device)
        self._ready = False

    def _run(self, x):
        with torch.inference_mode():
            return self._fn(self._params, torch.as_tensor(np.asarray(x, dtype=np.float32),
                                                          device=self._dev))

    def warmup(self, example: Any) -> None:
        self._run(example)
        if self._dev.type == "cuda":
            torch.cuda.synchronize(self._dev)
        self._ready = True

    def ready(self) -> bool:
        return self._ready

    def predict(self, request: dict, *args, **kwargs):
        x = request["inputs"]
        if self._pre is not None:
            x = self._pre(x)
        out = self._run(x)
        if self._post is not None:
            return self._post(out)
        return {"outputs": out.cpu().numpy().tolist()}


class LLMPredictor(FedMLPredictor):
    """LLM text-generation endpoint: KV-cache decode via
    train/llm/generation.py. Request: {"prompt": str, "max_new_tokens":
    int?, "temperature": float?, "seed": int?} -> {"text": str}.

    ``params`` is anything ``generation.decode_model`` takes; the decode
    model (weights in ``cfg.dtype``, or int8 under ``weight_quant="int8"``:
    ``serving/quant.py``) is built once, on ``device``, and shared by every
    request and engine."""

    def __init__(self, params, cfg, tokenizer, default_max_new_tokens: int = 64,
                 eos_id: "int | tuple | None" = None,
                 continuous: Optional[bool] = None,
                 num_slots: Optional[int] = None,
                 decode_chunk: Optional[int] = None,
                 paged: Optional[bool] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 admission=None,
                 device="cuda"):
        from ..train.llm.generation import decode_model

        self._model = decode_model(cfg, params, device=device)
        self._dev = self._model.embed.embedding.device
        self._cfg = cfg
        self._tok = tokenizer
        self._max_new = int(default_max_new_tokens)
        # stop token: an explicit id wins; else a '</s>' special if defined
        self._eos_id = eos_id if eos_id is not None else getattr(
            tokenizer, "special_tokens", {}
        ).get("</s>")
        # pool role under disaggregated serving (DisaggregatedReplicaSet
        # children get FEDML_SERVE_ROLE=prefill|decode): prefill replicas
        # exist to absorb cold long prompts and cache warming
        self.role = os.environ.get("FEDML_SERVE_ROLE", "mixed")
        self._ready = True  # flips False->True around warmup() when used
        # continuous batching (serving/continuous_batching.py): requests
        # stream through a slotted decode engine. Explicit arg wins; the
        # environment lets subprocess replicas opt in without code changes.
        if continuous is None:
            continuous = os.environ.get("FEDML_SERVE_CONTINUOUS", "0") not in ("0", "", "false")
        if paged is None:
            paged = os.environ.get("FEDML_SERVE_PAGED", "0") not in ("0", "", "false")
        self.engine = None
        if continuous or paged:
            slots = int(num_slots if num_slots is not None
                        else os.environ.get("FEDML_SERVE_SLOTS", "8"))
            chunk = int(decode_chunk if decode_chunk is not None
                        else os.environ.get("FEDML_SERVE_CHUNK", "8"))
            max_queue = int(os.environ.get("FEDML_SERVE_MAX_QUEUE", "4096"))
            if paged:
                from .continuous_batching import PagedContinuousBatchingEngine

                ps = int(page_size if page_size is not None
                         else os.environ.get("FEDML_SERVE_PAGE_SIZE", "16"))
                np_env = os.environ.get("FEDML_SERVE_KV_PAGES")
                pages = (int(num_pages) if num_pages is not None
                         else int(np_env) if np_env else None)
                self.engine = PagedContinuousBatchingEngine(
                    self._model, cfg, num_slots=slots, chunk=chunk,
                    page_size=ps, num_pages=pages, max_queue=max_queue,
                    admission=admission, device=self._dev)
            else:
                from .continuous_batching import ContinuousBatchingEngine

                self.engine = ContinuousBatchingEngine(
                    self._model, cfg, num_slots=slots, chunk=chunk,
                    max_queue=max_queue, device=self._dev)

    @classmethod
    def from_checkpoint(cls, path: str, quantize: str = "none", **kw) -> "LLMPredictor":
        """Serve an HF llama checkpoint directory: geometry from its
        ``config.json`` (``eos_token_id`` too, a list for llama-3's several
        stop tokens, unless ``eos_id`` is given), weights through
        ``checkpoint_import``, the tokenizer from ``tokenizer.json``; ``kw``
        goes to the constructor (``device`` among them). ``quantize="int8"``
        serves the checkpoint with weight-only int8 weights
        (``serving/quant.py``), quantized on the serving device: half the
        decode bytes of bf16, activations and KV cache unchanged."""
        import json

        from ..train.llm.checkpoint_import import config_from_hf, import_hf_checkpoint
        from ..train.llm.data import load_or_train_tokenizer

        # the mode is checked before the (possibly multi-GB) import
        if quantize not in ("none", "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        cfg = config_from_hf(path)
        params = import_hf_checkpoint(path, cfg)
        if quantize == "int8":
            from ..device import resolve_device
            from ..models.convert import params_from_jax
            from .quant import quantize_model_int8

            cfg, params = quantize_model_int8(cfg, params_from_jax(params),
                                              device=resolve_device(kw.get("device", "cuda")))
        tok = load_or_train_tokenizer(None, os.path.join(path, "tokenizer.json"))
        if "eos_id" not in kw:
            # config.json's eos_token_id is authoritative (token strings vary
            # across llama generations; the id does not)
            with open(os.path.join(path, "config.json")) as f:
                eos = json.load(f).get("eos_token_id")
            if isinstance(eos, list) and eos:
                # llama-3 style multi-EOS: generation stops on any of them
                kw["eos_id"] = tuple(int(e) for e in eos)
            elif isinstance(eos, int):
                kw["eos_id"] = eos
        return cls(params, cfg, tok, **kw)

    def warmup(self, example_prompt: str = "warmup") -> None:
        """Serve one request before readiness is reported (the first request
        pays the allocator's and cuBLAS's first-use costs)."""
        self._ready = False
        self.predict({"prompt": example_prompt})
        self._ready = True

    def ready(self) -> bool:
        return self._ready

    def predict(self, request: dict, *args, **kwargs):
        from ..train.llm.generation import generate_text

        if self.engine is not None:
            prompt_ids = self._tok.encode(str(request["prompt"]))
            tenant = str(request.get("tenant", "default"))
            if request.get("prefill_only"):
                # cache warming (prefill-pool traffic): one decoded token
                # forces the full prefill, and the paged engine registers
                # the prompt's chunks in its prefix cache on admit — later
                # requests sharing this prefix skip its compute + pages
                self.engine.generate(prompt_ids, 1, tenant=tenant)
                return {"warmed": True, "prompt_tokens": len(prompt_ids)}
            # continuous mode: this thread parks on its future; the engine's
            # worker interleaves every in-flight request through one
            # always-running decode step
            toks = self.engine.generate(
                prompt_ids,
                int(request.get("max_new_tokens", self._max_new)),
                temperature=float(request.get("temperature", 0.0)),
                seed=int(request.get("seed", 0)),
                eos_id=self._eos_id,
                tenant=tenant,
            )
            return {"text": self._tok.decode([int(t) for t in toks])}
        text = generate_text(
            self._model,
            self._cfg,
            self._tok,
            str(request["prompt"]),
            max_new_tokens=int(request.get("max_new_tokens", self._max_new)),
            temperature=float(request.get("temperature", 0.0)),
            seed=int(request.get("seed", 0)),
            eos_id=self._eos_id,
            device=self._dev,
        )
        return {"text": text}

    def predict_many(self, requests: list) -> list:
        """Dynamic-batching entry: requests with identical generation
        settings decode as ONE batched call (variable prompt lengths welcome
        — generation.generate_batch left-pads); mixed settings fall into
        per-setting groups."""
        from ..train.llm.generation import generate_batch

        out: list = [None] * len(requests)
        groups: dict = {}
        for i, r in enumerate(requests):
            temp = float(r.get("temperature", 0.0))
            if temp > 0.0:
                # sampled requests are NOT co-batched: rows of one batch
                # share a generator, so a fixed seed's output would depend
                # on batch composition — reproducibility wins over batching
                out[i] = self.predict(r)
                continue
            # greedy output is seed-independent: don't let client seeds
            # split what could be one batch
            k = int(r.get("max_new_tokens", self._max_new))
            groups.setdefault(k, []).append(i)
        for max_new, idxs in groups.items():
            try:
                prompts = [self._tok.encode(str(requests[i]["prompt"])) for i in idxs]
                toks = generate_batch(
                    self._model, self._cfg, prompts, max_new,
                    temperature=0.0, eos_id=self._eos_id, device=self._dev,
                )
                for i, t in zip(idxs, toks):
                    out[i] = {"text": self._tok.decode([int(x) for x in t])}
            except ValueError:
                # one bad request must not void the other members' decodes:
                # retry ITS members one by one, flagging individual failures
                for i in idxs:
                    try:
                        out[i] = self.predict(requests[i])
                    except ValueError as e:
                        out[i] = {"__error__": repr(e)}
        return out
