"""A/B of the 16-silo cross-silo round between two checkouts, on the card.

    python -m fedml_tpu_torch.tools.ab_round TREE_A TREE_B \\
        [--order ABBAABBA] [--repeats 2] [--out FILE]

Each letter of ``--order`` is one process, started in that tree, that runs
``chip_smoke.cross_silo_timed`` (phase 10's federation: ResNet-56, 16 client
threads over INMEMORY, ``CROSS_SILO``'s rounds, no resilience knob) once to
warm up and then ``--repeats`` times, and prints the mean seconds of the
rounds after the first of each run with its split. Interleaving the trees (A B B A ...) inside one call
keeps the card, its power limit and the host's load the same for both.

Where a tree has them, the process also counts and times the fleet-view
work on the round path: the client's ``_attach_telemetry_delta``, the
server's ``merge_client_telemetry`` and the health round
(``HealthTracker.end_round``). The summary gives, per tree, every run's
round seconds, their median, and those counts with the mean microseconds
of a call.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from typing import Dict, List

_CHILD = r"""
import gc, importlib, json, time

import chip_smoke as c

timed = {}


def wrap(module, cls, name):
    try:
        owner = getattr(importlib.import_module(module), cls)
    except (ImportError, AttributeError):
        return
    real = getattr(owner, name, None)
    if real is None:
        return
    row = timed.setdefault(name, [0, 0.0])

    def counted(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            row[0] += 1
            row[1] += time.perf_counter() - t0

    setattr(owner, name, counted)


wrap("fedml_tpu_torch.cross_silo.client.fedml_client_master_manager", "ClientMasterManager",
     "_attach_telemetry_delta")
wrap("fedml_tpu_torch.cross_silo.server.fedml_aggregator", "FedMLAggregator",
     "merge_client_telemetry")
wrap("fedml_tpu_torch.core.telemetry.health", "HealthTracker", "end_round")
c.cross_silo_timed({})
for _ in range(REPEATS):
    for row in timed.values():
        row[0], row[1] = 0, 0.0
    gc.collect()
    r, _ = c.cross_silo_timed({})
    print("AB_ROW", json.dumps({
        "round_s": r["round_s_mean_after_round_1"], "split_s": r["split_s_mean_after_round_1"],
        "calls": {k: {"n": n, "mean_us": (s / n * 1e6) if n else None}
                  for k, (n, s) in timed.items()}}), flush=True)
"""


def run_one(tree: str, repeats: int, timeout_s: float) -> List[dict]:
    proc = subprocess.run([sys.executable, "-c", _CHILD.replace("REPEATS", str(int(repeats)))],
                          cwd=tree, capture_output=True, text=True, timeout=timeout_s)
    rows = [json.loads(line[len("AB_ROW "):]) for line in proc.stdout.splitlines()
            if line.startswith("AB_ROW ")]
    if proc.returncode != 0 or len(rows) != repeats:
        raise RuntimeError(f"{tree}: exit {proc.returncode}, {len(rows)} rows\n"
                           f"{proc.stderr[-3000:]}")
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("tree_a")
    p.add_argument("tree_b")
    p.add_argument("--order", default="ABBAABBA")
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--timeout", type=float, default=600.0, help="seconds a process may take")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    trees = {"A": os.path.abspath(a.tree_a), "B": os.path.abspath(a.tree_b)}
    runs: Dict[str, List[dict]] = {"A": [], "B": []}
    for i, label in enumerate(a.order):
        rows = run_one(trees[label], a.repeats, a.timeout)
        runs[label].extend(rows)
        for row in rows:
            print("AB", i, label, json.dumps(row), flush=True)
    summary = {}
    for label, rows in runs.items():
        secs = [r["round_s"] for r in rows]
        calls = {}
        for r in rows:
            for k, v in r["calls"].items():
                n, us = calls.get(k, (0, 0.0))
                calls[k] = (n + v["n"], us + (v["mean_us"] or 0.0) * v["n"])
        summary[label] = {
            "tree": trees[label], "round_s": secs,
            "median_round_s": statistics.median(secs) if secs else None,
            "calls": {k: {"n": n, "mean_us": us / n if n else None} for k, (n, us) in calls.items()},
        }
    doc = {"order": a.order, "repeats": a.repeats, "summary": summary}
    if a.out:
        with open(a.out, "w") as f:
            json.dump(doc, f, indent=1)
    print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
