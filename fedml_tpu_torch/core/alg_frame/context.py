"""Cross-component key-value context: a copy of
``fedml_tpu/core/alg_frame/context.py`` (reference
``python/fedml/core/alg_frame/context.py``), a process-wide singleton that
passes side-band values (the round's cohort, the test data) between layers.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class Context:
    KEY_TEST_DATA = "test_data"
    KEY_CLIENT_MODEL_LIST = "client_model_list"
    KEY_METRICS_ON_AGGREGATED_MODEL = "metrics_on_aggregated_model"
    KEY_METRICS_ON_LAST_ROUND = "metrics_on_last_round"

    _instance: Optional["Context"] = None

    def __new__(cls) -> "Context":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance._store = {}
        return cls._instance

    def add(self, key: str, value: Any) -> None:
        self._store[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        return self._store.get(key, default)

    def clear(self) -> None:
        self._store.clear()

    @property
    def store(self) -> Dict[str, Any]:
        return self._store
