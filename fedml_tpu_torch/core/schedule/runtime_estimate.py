"""Per-(resource, client) runtime fitting for the sequential-training
scheduler.

A copy of ``fedml_tpu/core/schedule/runtime_estimate.py`` (numpy only).

Reference: core/schedule/runtime_estimate.py (linear_fit:4, t_sample_fit:16).
Runtime is modeled as t = a * num_samples + b per (resource, client) bucket;
uniform_client / uniform_gpu collapse the corresponding axis, exactly like
the reference's four branches — implemented here as one bucketing loop.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np


def linear_fit(x, y) -> Tuple[np.ndarray, np.poly1d, np.ndarray, float]:
    """Least-squares line; returns (coeffs, poly, fitted, mean relative error)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if len(x) < 2 or np.allclose(x, x[0]):
        # degenerate: constant model
        z1 = np.array([0.0, float(np.mean(y))])
    else:
        z1 = np.polyfit(x, y, 1)
    p1 = np.poly1d(z1)
    yvals = p1(x)
    denom = np.where(np.abs(y) > 1e-12, np.abs(y), 1.0)
    fit_error = float(np.mean(np.abs(yvals - y) / denom))
    return z1, p1, yvals, fit_error


def t_sample_fit(
    num_workers: int,
    num_clients: int,
    runtime_history: Dict[int, Dict[int, Any]],
    train_data_local_num_dict: Dict[int, int],
    uniform_client: bool = False,
    uniform_gpu: bool = False,
):
    """Fit cost functions from observed runtimes.

    runtime_history[worker][client] is a list of seconds (or scalar). Returns
    (fit_params, fit_funcs, fit_errors) keyed [resource][client] with axes
    collapsed to 0 when uniform.
    """
    samples: Dict[int, Dict[int, List[float]]] = {}
    sizes: Dict[int, Dict[int, List[float]]] = {}
    for w in range(num_workers):
        rkey = 0 if uniform_gpu else w
        for c in range(num_clients):
            ckey = 0 if uniform_client else c
            info = runtime_history.get(w, {}).get(c)
            if info is None:
                continue
            ts = info if isinstance(info, list) else [info]
            ts = [t for t in ts if t is not None and t > 0]
            if not ts:
                continue
            samples.setdefault(rkey, {}).setdefault(ckey, []).extend(ts)
            sizes.setdefault(rkey, {}).setdefault(ckey, []).extend(
                [float(train_data_local_num_dict[c])] * len(ts)
            )

    fit_params: Dict[int, Dict[int, np.ndarray]] = {}
    fit_funcs: Dict[int, Dict[int, np.poly1d]] = {}
    fit_errors: Dict[int, Dict[int, float]] = {}
    for r in samples:
        for c in samples[r]:
            z1, p1, _, err = linear_fit(sizes[r][c], samples[r][c])
            fit_params.setdefault(r, {})[c] = z1
            fit_funcs.setdefault(r, {})[c] = p1
            fit_errors.setdefault(r, {})[c] = err
    return fit_params, fit_funcs, fit_errors
