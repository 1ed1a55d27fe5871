"""Autoregressive generation with a KV cache (the serving decode path).

Counterpart of ``fedml_tpu/train/llm/generation.py``. The transformer runs
as a decode model (``decode_model``: dense weights held in ``cfg.dtype``,
cast once at load) over an explicit cache (``models.transformer.init_cache``:
per layer ``[B, max_seq_len, kv, hd]`` keys and values written at a running
index). Prefill is one batched pass over the prompt; the per-token loop is a
device-side Python loop whose carry (cache, token, position, EOS ``done``
mask) never leaves the device: no host sync per token, and like the JAX
``lax.scan`` it runs to full length, filling after EOS.

Shapes are bucketed as in JAX, although eager PyTorch compiles nothing:
prompts are right-padded to a 16-token bucket with the write index rewound
to the true length (``_rewind_cache`` holds the exactness argument), the
loop runs to a 16-multiple of ``max_new_tokens`` and the output is sliced,
and ``generate_batch`` pads the batch to a power of two. Decode always uses
the plain masked attention, never the flash kernels.

Sampling draws from a ``torch.Generator`` seeded from the request's seed
(the Gumbel-max trick: argmax of logits/T plus Gumbel noise is a draw from
softmax(logits/T)). It cannot reproduce JAX's draws; greedy is argmax in
both.

Correctness keystone (tests/test_torch_generation.py): stepped KV-cache
logits equal the full non-cached forward at every position, and the JAX
package's.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ...models.convert import params_from_jax
from ...models.transformer import TransformerConfig, TransformerLM, init_cache


def decode_model(cfg: TransformerConfig, params=None, *, device="cuda") -> TransformerLM:
    """The decode-mode twin of a training config, on ``device``, holding
    ``params``: a ``TransformerLM`` (its weights), a state dict of the port,
    a nested dict in the JAX layout, or None (uninitialised; see
    ``TransformerLM.reset_parameters``). Dense weights, the embedding and
    LoRA factors are cast once to ``cfg.dtype`` as they load. A model that
    already is this twin on ``device`` is returned as it is, so callers may
    pass the result back in without a second copy.

    The twin's config never carries a page pool: ``kv_page_size`` belongs to
    the cache a paged engine allocates, and one decode model serves every
    mode (``models.transformer``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    dcfg = dataclasses.replace(cfg, decode=True, remat=False, attention_impl="xla",
                               kv_page_size=0, kv_num_pages=0)
    if isinstance(params, TransformerLM):
        if params.cfg == dcfg and params.embed.embedding.device == dev:
            return params
        params = params.state_dict()
    model = TransformerLM(dcfg, device=dev)
    if params is not None:
        if any(isinstance(v, Mapping) for v in params.values()):
            params = params_from_jax(params)
        model.load_state_dict(params)  # copy_ casts f32 -> cfg.dtype
    model.requires_grad_(False)
    return model.eval()


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            temperature: float) -> torch.Tensor:
    """argmax at temperature 0; else one draw per row from
    softmax(logits / T) (Gumbel-max: noise from ``generator``)."""
    if temperature <= 0.0:
        return logits.argmax(-1)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return (logits / max(temperature, 1e-6) - torch.log(-torch.log(u))).argmax(-1)


def _rewind_cache(cache: dict, true_len) -> dict:
    """Set every layer's KV write index to the TRUE prompt length, in place.
    Prompts are right-padded to a bucket before prefill; the padded slots'
    garbage keys/values sit at positions >= true_len, and with the index
    rewound each of those slots is OVERWRITTEN by a real decoded token before
    any query position can attend to it — so bucketed prefill is exact."""
    for layer in cache.values():
        layer["attn"]["idx"].fill_(true_len)
    return cache


def _eos_tuple(eos_id) -> Optional[Tuple[int, ...]]:
    if eos_id is None:
        return None
    return tuple(int(e) for e in eos_id) if isinstance(eos_id, (list, tuple)) else (int(eos_id),)


def _check_ids(ids: np.ndarray, cfg: TransformerConfig) -> None:
    """Token ids come from outside: an id past the embedding would read out
    of bounds on the card, so refuse it here, on the host."""
    if ids.size and (ids.min() < 0 or ids.max() >= cfg.vocab_size):
        raise ValueError(f"token ids must lie in [0, {cfg.vocab_size}), got "
                         f"[{ids.min()}, {ids.max()}]")


def _prefill(model: TransformerLM, prompt_padded: torch.Tensor, true_len: int):
    """One decode-mode pass over a right-padded prompt [B, P_bucket] into a
    fresh cache; returns (cache rewound to ``true_len``, logits [B, vocab]
    of the last real token)."""
    B, P_b = prompt_padded.shape
    cache = init_cache(model.cfg, B, prompt_padded.device)
    positions = torch.arange(P_b, device=prompt_padded.device).expand(B, P_b)
    logits = model(prompt_padded, positions, cache=cache)
    return _rewind_cache(cache, true_len), logits[:, true_len - 1]


def _prefill_padded(model: TransformerLM, prompt: Sequence[int], device):
    """B=1 prefill of one prompt through its 16-token bucket (the engines'
    admission path)."""
    P = len(prompt)
    P_b = min(-(-P // 16) * 16, model.cfg.max_seq_len)
    ids = torch.tensor([list(prompt) + [0] * (P_b - P)], dtype=torch.long, device=device)
    return _prefill(model, ids, P)


def _decode_loop(model: TransformerLM, cache: dict, first_logits: torch.Tensor,
                 pos0: torch.Tensor, generator: Optional[torch.Generator],
                 temperature: float, max_new: int, eos_ids: Optional[Tuple[int, ...]],
                 attn_start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The token loop: ``max_new - 1`` single-token steps after the token
    sampled from the prefill logits; returns [B, max_new]. Everything it
    carries stays on the device."""
    B = first_logits.shape[0]
    dev = first_logits.device
    out = torch.empty((B, max_new), dtype=torch.long, device=dev)
    tok = _sample(first_logits, generator, temperature)
    if eos_ids is not None:
        eos_t = torch.tensor(eos_ids, dtype=torch.long, device=dev)
        done = torch.isin(tok, eos_t)
    pos = pos0
    for i in range(max_new - 1):
        out[:, i] = tok
        logits = model(tok[:, None], pos[:, None], attn_start, cache=cache)
        nxt = _sample(logits[:, -1], generator, temperature)
        if eos_ids is not None:
            nxt = torch.where(done, eos_ids[0], nxt)
            done = done | torch.isin(nxt, eos_t)
        tok, pos = nxt, pos + 1
    out[:, -1] = tok
    return out


@torch.inference_mode()
def generate(
    params,
    cfg: TransformerConfig,
    prompt,
    max_new_tokens: int,
    *,
    temperature: float = 0.0,
    seed: int = 0,
    eos_id=None,
    device="cuda",
) -> torch.Tensor:
    """Generate [B, max_new_tokens] continuations (int64, on ``device``) of
    ``prompt`` [B, P] (ids: a tensor, array or nested list).

    ``params``: a decode model from ``decode_model`` (used as it is) or
    anything ``decode_model`` loads (cast anew on every call). temperature 0
    = greedy; otherwise sampling at the given temperature from a generator
    seeded with ``seed``. ``eos_id`` may be one id or a sequence (llama-3
    instruct models stop on <|eot_id|> while config.json lists several);
    positions after any EOS are filled (the loop still runs to full length)."""
    ids = np.asarray(prompt.cpu() if isinstance(prompt, torch.Tensor) else prompt, np.int64)
    if ids.ndim != 2:
        raise ValueError(f"prompt must be [B, P], got shape {ids.shape}")
    B, P = ids.shape
    eos_ids = _eos_tuple(eos_id)
    if P < 1:
        raise ValueError("prompt must contain at least one token")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if P + max_new_tokens > cfg.max_seq_len:
        raise ValueError(
            f"prompt {P} + new {max_new_tokens} exceeds max_seq_len {cfg.max_seq_len}"
        )
    _check_ids(ids, cfg)
    model = decode_model(cfg, params, device=device)
    dev = model.embed.embedding.device
    # the loop runs to a 16-multiple (the validation above guarantees the
    # min is still >= max_new_tokens); the prompt is right-padded to its
    # 16-bucket with the write index rewound (see _rewind_cache)
    bucket = min(-(-max_new_tokens // 16) * 16, cfg.max_seq_len - P)
    P_b = min(-(-P // 16) * 16, cfg.max_seq_len)
    padded = torch.zeros((B, P_b), dtype=torch.long, device=dev)
    padded[:, :P] = torch.from_numpy(ids).to(dev)
    cache, first_logits = _prefill(model, padded, P)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    out = _decode_loop(model, cache, first_logits, torch.full((B,), P, device=dev), gen,
                       float(temperature), bucket, eos_ids)
    return out[:, :max_new_tokens]


def _batch_bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


@torch.inference_mode()
def generate_batch(
    params,
    cfg: TransformerConfig,
    prompts,
    max_new_tokens: int,
    *,
    temperature: float = 0.0,
    seed: int = 0,
    eos_id=None,
    device="cuda",
) -> List[torch.Tensor]:
    """Batched generation over VARIABLE-length prompts (the dynamic-batching
    serving path): prompts are LEFT-padded to a shared 16-token length
    bucket — all rows then share the cache write index while ``attn_start``
    masks each row's pad prefix — and the batch is padded to a power of two
    (pad rows replay row 0), as in JAX. Greedy tokens equal per-prompt
    :func:`generate`'s where the arithmetic does not depend on the batch
    size (the CPU tests; on the card cuBLAS may pick other GEMMs).

    ``prompts``: sequence of token-id sequences. Returns a list of
    [max_new_tokens] tensors."""
    n = len(prompts)
    if n == 0:
        return []
    lens = [len(p) for p in prompts]
    if min(lens) < 1:
        raise ValueError("every prompt must contain at least one token")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    P_max = max(lens)
    if P_max + max_new_tokens > cfg.max_seq_len:
        raise ValueError(
            f"longest prompt {P_max} + new {max_new_tokens} exceeds max_seq_len {cfg.max_seq_len}"
        )
    eos_ids = _eos_tuple(eos_id)
    for p in prompts:
        _check_ids(np.asarray(p, np.int64), cfg)
    model = decode_model(cfg, params, device=device)
    dev = model.embed.embedding.device

    # the batch path CANNOT rewind the shared write index (rows are
    # left-padded to end at P_b), so decode writes land at P_b..P_b+new-1:
    # P_b itself must leave room. At the boundary drop the bucket padding
    # (an exact-length prefill) rather than write past the cache.
    P_b = -(-P_max // 16) * 16
    if P_b + max_new_tokens > cfg.max_seq_len:
        P_b = P_max
    B_b = _batch_bucket(n)
    rows, starts = [], []
    for i in range(B_b):
        p = [int(t) for t in (prompts[i] if i < n else prompts[0])]  # pad rows: replay row 0
        pad = P_b - len(p)
        rows.append([0] * pad + p)
        starts.append(pad)
    prompt_padded = torch.tensor(rows, dtype=torch.long, device=dev)
    start = torch.tensor(starts, dtype=torch.long, device=dev)

    cache = init_cache(model.cfg, B_b, dev)
    positions = (torch.arange(P_b, device=dev)[None, :] - start[:, None]).clamp_min(0)
    first_logits = model(prompt_padded, positions, start, cache=cache)[:, -1]
    bucket = min(-(-max_new_tokens // 16) * 16, cfg.max_seq_len - P_b)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    out = _decode_loop(model, cache, first_logits, P_b - start, gen, float(temperature),
                       bucket, eos_ids, attn_start=start)
    return [out[i, :max_new_tokens] for i in range(n)]


def generate_text(
    params,
    cfg: TransformerConfig,
    tokenizer,
    prompt_text: str,
    max_new_tokens: int = 64,
    **kw,
) -> str:
    """Tokenizer-roundtrip convenience used by the serving predictor."""
    out = generate(params, cfg, [tokenizer.encode(prompt_text)], max_new_tokens, **kw)
    return tokenizer.decode(out[0].tolist())
