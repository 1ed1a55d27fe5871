"""LoRA adapter plumbing on nested dicts with the flax path names.

Counterpart of ``fedml_tpu/models/lora.py``. Adapters are the leaves named
``lora_a``/``lora_b`` (``layer_0/attn/q_proj/lora_a``, ...). These helpers
split them from the base tree and merge them back, so that federated rounds
ship only the adapter subtree over the WAN, in the same layout a JAX peer
uses. Leaves may be numpy arrays or torch tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

LORA_KEYS = ("lora_a", "lora_b")


def is_lora_path(path: Tuple[str, ...]) -> bool:
    return any(p in LORA_KEYS for p in path)


def _flatten(tree: Dict, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def lora_mask(params: Dict) -> Dict:
    """Same structure as ``params``: True where the leaf is a LoRA adapter."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return is_lora_path(path)

    return walk(params, ())


def split_lora(params: Dict) -> Tuple[Dict, Dict]:
    """-> (adapters_subtree, base_subtree) as nested dicts with the same
    paths (missing branches pruned)."""

    def walk(node, select_lora: bool, in_lora_branch=False):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                child = walk(v, select_lora, in_lora_branch or k in LORA_KEYS)
                if child is not None and (not isinstance(child, dict) or child):
                    out[k] = child
            return out
        return node if (in_lora_branch == select_lora) else None

    return walk(params, True), walk(params, False)


def merge_lora(base: Dict, adapters: Dict) -> Dict:
    """Graft the adapter subtree back onto the base tree."""

    def walk(b, a):
        if isinstance(a, dict):
            out = dict(b) if isinstance(b, dict) else {}
            for k, v in a.items():
                out[k] = walk(out.get(k, {}), v)
            return out
        return a

    return walk(base, adapters)


def _size(leaf: Any) -> int:
    n = 1
    for d in leaf.shape:
        n *= int(d)
    return n


def count_lora_params(params: Dict) -> Tuple[int, int]:
    """(adapter_params, total_params)."""
    flat = list(_flatten(params))
    lora = sum(_size(leaf) for path, leaf in flat if is_lora_path(path))
    total = sum(_size(leaf) for _, leaf in flat)
    return lora, total
