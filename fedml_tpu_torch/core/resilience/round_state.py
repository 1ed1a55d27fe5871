"""Durable round state: crash-safe checkpoints at every round boundary.

Counterpart of ``fedml_tpu/core/resilience/round_state.py``, built on the
port's :class:`fedml_tpu_torch.utils.checkpoint.CheckpointManager`
(``torch.save`` of host copies; the JAX package's store is orbax). Each
round boundary persists one *round state*:

- the **state dicts** (global model plus any server-side algorithm state)
  go through the manager as one step, enqueued async (``wait=False``): the
  caller pays the host snapshot, a waiter thread writes the file;
- the **metadata** (round index, numpy RNG state, sampled cohort, health
  snapshot, trainer round counter) is a JSON sidecar ``meta-<round>.json``
  written atomically at enqueue, with the JAX package's keys;
- the manager's **watermark** commits the step only after its file (and so
  its sidecar, written before) is renamed into place, so :meth:`resume`
  never sees a torn save: a SIGKILL mid-save resumes from the previous
  complete round and recomputes the lost one.

``resume()`` restores the newest complete round. The stored tree is a dict
keyed by the caller's state names (``{"model": ..., "scaffold_c": ...}``);
the caller passes the same-named template, whose tensors' devices the
restored tensors take.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from ...utils.checkpoint import CheckpointManager, write_durably

log = logging.getLogger(__name__)

META_PREFIX = "meta-"


def _json_default(v: Any) -> Any:
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return repr(v)


def capture_numpy_rng() -> Dict[str, Any]:
    """The global ``np.random`` stream as a JSON-safe dict."""
    name, keys, pos, has_gauss, cached = np.random.get_state()
    return {
        "name": str(name),
        "keys": [int(k) for k in keys],
        "pos": int(pos),
        "has_gauss": int(has_gauss),
        "cached_gaussian": float(cached),
    }


def restore_numpy_rng(state: Optional[Dict[str, Any]]) -> None:
    if not state:
        return
    np.random.set_state((
        state["name"],
        np.array(state["keys"], dtype=np.uint32),
        int(state["pos"]),
        int(state["has_gauss"]),
        float(state["cached_gaussian"]),
    ))


@dataclass
class RoundState:
    """One restored round boundary."""

    round_idx: int
    state: Dict[str, Any]                      # named state dicts (model, server state, ...)
    meta: Dict[str, Any] = field(default_factory=dict)

    @property
    def cohort(self) -> Optional[List[int]]:
        c = self.meta.get("cohort")
        return None if c is None else [int(x) for x in c]


class RoundStateStore:
    """Durable per-round state for one training run."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.ckpt = CheckpointManager(self.directory, max_to_keep=max_to_keep)
        self._max_to_keep = int(max_to_keep)

    # --- save -------------------------------------------------------------
    def save_round(
        self,
        round_idx: int,
        state: Dict[str, Any],
        *,
        rng: bool = True,
        cohort: Optional[List[int]] = None,
        health: Optional[Dict[str, Any]] = None,
        extra_meta: Optional[Dict[str, Any]] = None,
        wait: bool = False,
    ) -> bool:
        """Persist round ``round_idx``. Async by default: the caller pays the
        host snapshot, a background waiter commits the watermark. Returns
        False iff the save was dropped (previous async save still writing)."""
        meta: Dict[str, Any] = {"round_idx": int(round_idx)}
        if rng:
            meta["numpy_rng"] = capture_numpy_rng()
        if cohort is not None:
            meta["cohort"] = [int(c) for c in cohort]
        if health is not None:
            meta["health"] = health
        if extra_meta:
            meta.update(extra_meta)
        self._write_meta(round_idx, meta)
        ok = self.ckpt.save(int(round_idx), state, wait=wait)
        if ok:
            from . import note

            note(last_checkpoint_enqueued_round=int(round_idx), resilience_dir=self.directory)
        self._prune_meta()
        return ok

    def _write_meta(self, round_idx: int, meta: Dict[str, Any]) -> None:
        path = os.path.join(self.directory, f"{META_PREFIX}{int(round_idx)}.json")
        # durable before the step file that the watermark then commits
        write_durably(path, lambda f: f.write(json.dumps(meta, default=_json_default).encode()))

    def _meta_rounds(self) -> List[int]:
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for n in names:
            if n.startswith(META_PREFIX) and n.endswith(".json"):
                try:
                    out.append(int(n[len(META_PREFIX):-len(".json")]))
                except ValueError:
                    continue
        return sorted(out)

    def _prune_meta(self) -> None:
        """Keep meta sidecars roughly in step with the manager's max_to_keep
        (one spare so the watermark's step always has its meta)."""
        rounds = self._meta_rounds()
        for r in rounds[: max(0, len(rounds) - (self._max_to_keep + 1))]:
            try:
                os.remove(os.path.join(self.directory, f"{META_PREFIX}{r}.json"))
            except OSError:
                pass

    def read_meta(self, round_idx: int) -> Optional[Dict[str, Any]]:
        try:
            with open(os.path.join(self.directory, f"{META_PREFIX}{int(round_idx)}.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # --- resume -----------------------------------------------------------
    def latest_complete_round(self) -> Optional[int]:
        return self.ckpt.latest_complete_step()

    def resume(self, template: Optional[Dict[str, Any]] = None) -> Optional[RoundState]:
        """Restore the newest complete round (None when the store is empty).
        ``template`` is the same-named dict passed to :meth:`save_round`;
        the restored tensors go to its tensors' devices."""
        step = self.latest_complete_round()
        if step is None:
            return None
        state = self.ckpt.restore(step, template=template)
        meta = self.read_meta(step) or {"round_idx": int(step)}
        from . import note

        note(resumed_round=int(step))
        log.info("resilience: resuming from round %d (%s)", step, self.directory)
        return RoundState(round_idx=int(step), state=state, meta=meta)

    def wait(self) -> None:
        self.ckpt.wait_until_finished()

    def close(self) -> None:
        self.ckpt.close()
