"""Step checkpoints with ``torch.save``.

Counterpart of ``fedml_tpu/utils/checkpoint.py`` (orbax there). A step is
one file ``step_<n>.pt`` holding the saved tree, written
to a temporary name and renamed into place, so a reader never sees a torn
step. The newest ``max_to_keep`` steps are kept. Saves are synchronous; the
JAX manager's async watermark path waits for a later slice (ROADMAP.md).
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, List, Optional

import torch

log = logging.getLogger(__name__)

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_FILE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any) -> None:
        """Persist ``tree`` (nested dicts of tensors) as ``step``."""
        tmp = self._path(step) + ".tmp"
        torch.save(tree, tmp)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[: -self.max_to_keep]:
            os.remove(self._path(old))
        log.info("checkpoint step %d saved to %s", step, self.directory)

    def restore(self, step: Optional[int] = None) -> Optional[Any]:
        """The tree saved at ``step`` (default: the newest), or None."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu", weights_only=True)
