"""Typed parameter bag passed through the trainer and aggregator hooks: a
copy of ``fedml_tpu/core/alg_frame/params.py`` (reference
``python/fedml/core/alg_frame/params.py``), an attribute dict the trust
middleware uses to carry auxiliary tensors beside the model weights.
"""

from __future__ import annotations

from typing import Any, Iterator, Tuple


class Params:
    def __init__(self, **kwargs: Any):
        self.__dict__.update(kwargs)

    def add(self, name: str, value: Any) -> "Params":
        self.__dict__[name] = value
        return self

    def get(self, name: str, default: Any = None) -> Any:
        return self.__dict__.get(name, default)

    def __contains__(self, name: str) -> bool:
        return name in self.__dict__

    def items(self) -> Iterator[Tuple[str, Any]]:
        return iter(self.__dict__.items())
