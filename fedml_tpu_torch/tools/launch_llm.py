"""Train the LLM over a mesh of ranks with one command.

Starts ``--nproc`` processes (``tools/launch_silo.py``: a rendezvous on a
free local port, one deadline, a failed rank ends them all); each joins
the process group (``parallel/multihost.init_distributed``) and runs
``LLMTrainer.train`` with the fields given as ``key=value`` (any field of
``ModelArguments``, ``DatasetArguments`` or ``ExperimentArguments``, e.g.
the mesh's ``dp``, ``fsdp``, ``tp``, ``sp``, ``ep``, whose product is the
number of processes). Rank 0 prints the metrics as one JSON line::

    python -m fedml_tpu_torch.tools.launch_llm --nproc 2 -- fsdp=2 max_steps=3 \\
        d_model=512 n_layers=2 seq_len=512 lora_rank=8

Rank r computes on ``cuda:(r % device_count)``; ranks that share a card
talk over gloo, ranks with a card each over NCCL. ``--device cpu`` keeps
every rank on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, List, Optional, Sequence


def _field_types() -> Dict[str, tuple]:
    from ..train.llm.configurations import DatasetArguments, ExperimentArguments, ModelArguments

    out = {}
    for cls in (ModelArguments, DatasetArguments, ExperimentArguments):
        for f in dataclasses.fields(cls):
            out[f.name] = (cls, f)
    return out


def _value(field, raw: str):
    default = field.default if field.default is not dataclasses.MISSING else None
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return None if raw.lower() == "none" else raw


def build_arguments(pairs: Sequence[str]):
    """(ModelArguments, DatasetArguments, ExperimentArguments) from
    ``key=value`` strings; an unknown key raises ValueError."""
    from ..train.llm.configurations import DatasetArguments, ExperimentArguments, ModelArguments

    fields = _field_types()
    given: Dict[type, dict] = {ModelArguments: {}, DatasetArguments: {}, ExperimentArguments: {}}
    for pair in pairs:
        key, sep, raw = pair.partition("=")
        if not sep or key not in fields:
            raise ValueError(f"not a field=value of the LLM arguments: {pair!r}")
        cls, field = fields[key]
        given[cls][key] = _value(field, raw)
    return (ModelArguments(**given[ModelArguments]), DatasetArguments(**given[DatasetArguments]),
            ExperimentArguments(**given[ExperimentArguments]))


def rank_main(pairs: Sequence[str], device: Optional[str]) -> int:
    """One rank: join the group, train, leave; rank 0 prints the metrics."""
    from ..parallel import multihost
    from ..train.llm.llm_trainer import LLMTrainer

    ma, da, ea = build_arguments(pairs)
    multihost.init_distributed(device=device)
    try:
        metrics = LLMTrainer(ma, da, ea, device=device or "cuda").train()
        if multihost.is_main_process():
            print(json.dumps({"metrics": metrics,
                              "collectives": multihost.collective_stats()}), flush=True)
    finally:
        multihost.shutdown_distributed()
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=1, help="ranks (the mesh's size)")
    ap.add_argument("--timeout", type=float, default=24 * 3600.0,
                    help="seconds before every rank still running is killed")
    ap.add_argument("--device", default=None, help="cpu keeps the ranks on the CPU")
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--rank-main", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("fields", nargs=argparse.REMAINDER, help="-- key=value ...")
    a = ap.parse_args(argv)
    fields = a.fields[1:] if a.fields[:1] == ["--"] else a.fields
    build_arguments(fields)  # refuse a bad field before any process starts
    if a.rank_main:
        return rank_main(fields, a.device)
    from .launch_silo import launch

    cmd = [sys.executable, "-m", "fedml_tpu_torch.tools.launch_llm", "--rank-main"]
    if a.device:
        cmd += ["--device", a.device]
    rcs = launch(cmd + ["--", *fields], a.nproc, log_dir=a.log_dir).wait(a.timeout)
    if any(rcs):
        print(f"ranks exited {rcs}", file=sys.stderr)
    return next((rc for rc in rcs if rc != 0), 0)


if __name__ == "__main__":
    sys.exit(main())
