"""Step checkpoints with ``torch.save``, synchronous or async behind a
completion watermark.

Counterpart of ``fedml_tpu/utils/checkpoint.py`` (orbax there). A step is
one file ``step_<n>.pt`` holding the saved tree as CPU tensors (the file
is ``torch.save`` of the tree itself, as the synchronous manager wrote it
before the async path came), written to a temporary name, fsynced and
renamed into place, so a reader never sees a torn step. The newest ``max_to_keep`` steps are kept.

The tree is snapshotted when the save is called: every tensor is copied to
the host (``.detach().to("cpu", copy=True)``) before the call returns, so a
caller may update its tensors in place at once (the trainer loads the next
global into its module, FedOpt and SCAFFOLD step in place) without touching
what is being written, and a CPU process can restore a card's store.

Async saves (``wait=False``), as in the JAX package: one background waiter
thread writes the step file and then commits ``<dir>/.watermark``
atomically (temporary name, fsync, ``os.replace``).
``latest_complete_step()`` reads the watermark, so a resume after a SIGKILL
never trusts a step whose write was still in flight. At most one async save
is in flight: a ``wait=False`` save arriving while the previous one is still
writing is *dropped* (counted in ``checkpoint.dropped``) rather than queued,
so checkpointing never backs up behind slow storage. Save latency lands in
the ``checkpoint_save_seconds`` histogram either way.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
from typing import Any, List, Optional

import torch

from ..core import telemetry as tel

log = logging.getLogger(__name__)

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")
WATERMARK_FILE = ".watermark"

# metric names (rendered as fedml_checkpoint_save_seconds /
# fedml_checkpoint_dropped_total, the JAX package's series)
SAVE_SECONDS_HISTOGRAM = "checkpoint_save_seconds"
DROPPED_COUNTER = "checkpoint.dropped"


class OwnedTree(dict):
    """A tree of host tensors its caller made for one save and gives up (the
    trainer's gathered checkpoint): :func:`host_snapshot` takes it as it is,
    as a plain dict, without a second copy."""


def host_snapshot(tree: Any) -> Any:
    """``tree`` (nested dicts, lists and tuples) with every tensor copied to
    the host; other leaves as they are. An :class:`OwnedTree` is not copied."""
    if isinstance(tree, OwnedTree):
        return dict(tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: host_snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_snapshot(v) for v in tree)
    return tree


def place_like(tree: Any, template: Any) -> Any:
    """``tree`` with each tensor moved to the device of the tensor at the
    same place in ``template``; parts the template does not cover stay as
    they are (on the host)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(template.device) if isinstance(template, torch.Tensor) else tree
    if isinstance(tree, dict):
        if not isinstance(template, dict):
            return tree
        return {k: place_like(v, template[k]) if k in template else v for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and isinstance(template, (list, tuple)) \
            and len(tree) == len(template):
        return type(tree)(place_like(v, t) for v, t in zip(tree, template))
    return tree


def _fsync_dir(directory: str) -> None:
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_durably(path: str, write) -> None:
    """Write through ``write(file)`` to a temporary name, fsync it and
    rename it into place."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._async_lock = threading.Lock()
        self._async_thread: Optional[threading.Thread] = None

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
        """The newest step file on disk (complete: files are renamed into
        place whole)."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    # --- watermark (the async-save commit point) --------------------------
    def _watermark_path(self) -> str:
        return os.path.join(self.directory, WATERMARK_FILE)

    def _read_watermark(self) -> Optional[int]:
        try:
            with open(self._watermark_path()) as f:
                return int(json.load(f)["step"])
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def _commit_watermark(self, step: int) -> None:
        """Record ``step`` as fully written. Monotonic: a late waiter for an
        old step never moves the mark back."""
        current = self._read_watermark()
        if current is not None and current >= step:
            return
        write_durably(self._watermark_path(),
                       lambda f: f.write(json.dumps({"step": int(step)}).encode()))

    def latest_complete_step(self) -> Optional[int]:
        """The newest step whose save finished (watermark-committed); for a
        store without a watermark, the newest step file."""
        mark = self._read_watermark()
        return mark if mark is not None else self.latest_step()

    # --- save/restore -----------------------------------------------------
    def _write(self, step: int, payload: Any, t0: float) -> None:
        write_durably(self._path(step), lambda f: torch.save(payload, f))
        self._commit_watermark(step)
        keep = self.latest_complete_step()
        for old in self.all_steps()[: -self.max_to_keep]:
            if old != keep:
                os.remove(self._path(old))
        tel.histogram(SAVE_SECONDS_HISTOGRAM).observe(time.perf_counter() - t0)

    def save(self, step: int, tree: Any, *, wait: bool = True) -> bool:
        """Persist ``tree`` (nested dicts and lists of tensors) as ``step``.
        ``wait=True`` returns once the step file and the watermark are
        durable. ``wait=False`` takes the host snapshot (none for an
        :class:`OwnedTree`) and hands the write to a background waiter
        thread. Returns False iff the save was dropped because a previous
        async save is still writing."""
        with self._async_lock:
            if self._async_thread is not None and self._async_thread.is_alive():
                if not wait:
                    tel.counter(DROPPED_COUNTER).add(1)
                    log.warning("checkpoint step %d dropped: previous async save still in flight",
                                step)
                    return False
                self._async_thread.join()
            t0 = time.perf_counter()
            payload = host_snapshot(tree)
            if wait:
                self._write(step, payload, t0)
                log.info("checkpoint step %d saved to %s", step, self.directory)
                return True

            def _save_and_commit() -> None:
                try:
                    self._write(step, payload, t0)
                    log.info("checkpoint step %d finalized (async) in %s", step, self.directory)
                except Exception:  # noqa: BLE001 - a torn save stays below the watermark
                    log.exception("async checkpoint step %d failed to finalize", step)

            self._async_thread = threading.Thread(
                target=_save_and_commit, name=f"ckpt-finalize-{step}", daemon=True)
            self._async_thread.start()
            return True

    def wait_until_finished(self) -> None:
        """Block until any in-flight async save is written and watermarked."""
        with self._async_lock:
            th = self._async_thread
        if th is not None and th.is_alive():
            th.join()

    def restore(self, step: Optional[int] = None, template: Any = None) -> Optional[Any]:
        """The tree saved at ``step`` (default: the newest complete one), or
        None. Tensors load on the host, or on the devices of ``template``'s
        tensors where it is given (:func:`place_like`)."""
        step = step if step is not None else self.latest_complete_step()
        if step is None:
            return None
        state = torch.load(self._path(step), map_location="cpu", weights_only=True)
        return place_like(state, template) if template is not None else state

    def close(self) -> None:
        self.wait_until_finished()
