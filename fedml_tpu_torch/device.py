"""Device selection (counterpart of ``fedml_tpu/device.py``).

Entry points take ``device=`` (default ``"cuda"``). There is no silent CPU
fallback: asking for CUDA where there is none raises, and the CPU is used
only when the caller names it.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

import torch

log = logging.getLogger(__name__)


def resolve_device(device: Any = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and CUDA is
    not available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for CUDA, which is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


def get_device(args: Optional[Any] = None) -> torch.device:
    """The compute device for this process: ``cuda:<gpu_id>`` unless
    ``args.using_gpu`` is false, in which case the CPU."""
    using_gpu = bool(getattr(args, "using_gpu", True)) if args is not None else True
    if not using_gpu:
        return torch.device("cpu")
    gpu_id = int(getattr(args, "gpu_id", 0) or 0) if args is not None else 0
    dev = resolve_device(f"cuda:{gpu_id % max(1, torch.cuda.device_count())}")
    log.info("device = %s", dev)
    return dev

