"""Data zoo facade: ``fedml_tpu_torch.data.load(args)`` returns
``(dataset_tuple, class_num)``, as the JAX package's ``data.load`` does."""

from __future__ import annotations

from typing import Any


def load(args: Any):
    from .data_loader import load as _load

    dataset = _load(args)
    return dataset, dataset[-1]
