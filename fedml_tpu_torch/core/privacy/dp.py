"""Accounted differential privacy at the server fold: counterpart of
``fedml_tpu/core/privacy/dp.py``.

Central-DP FedAvg: each published aggregate carries Gaussian noise
calibrated to ``noise_multiplier * l2_clip`` on the *sum* (so ``z * C / n``
on the mean). The dp-only buffer session replaces the publish's
``acc * (1/W)`` with ``acc * s + sigma * N(0, 1)`` on the bucketed engine's
flat f32 accumulator: an in-place scale, one ``torch.randn`` of the whole
vector and one in-place add, where the JAX package runs one jitted dispatch
that draws a key a leaf. The secagg+dp composition noises the unmasked
mean's flat vector the same way with ``s = 1``, and the synchronous
cross-silo round noises its fold's mean through :meth:`DPFold.noise_tree`.

The noise comes from an explicit ``torch.Generator`` on the vector's device,
seeded from ``dp_seed``: a run is reproducible on one device, but its draws
are not JAX's (no PRNG matches across frameworks), so tests hold the noise
to its statistics.

Every noised release steps the RDP accountant (``core/dp/budget_accountant``):
spent epsilon at the configured delta surfaces as ``fedml_dp_epsilon_spent``
/ ``fedml_dp_budget_frac`` gauges, a `/statusz` ``privacy`` section entry,
the ``privacy.dp_epsilon_spent`` / ``privacy.dp_budget_frac`` tsdb series
(behind the ``dp_budget_exhaustion`` SLO row, which fires while budget_frac
is still below 1.0), and a ``dp.accountant_step`` flight-recorder mark per
accountant step, as in the JAX package.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from .. import telemetry as tel
from ..dp.budget_accountant.rdp_accountant import RDPAccountant
from ..telemetry import flight_recorder

StateDict = Dict[str, torch.Tensor]

NOISED_PUBLISH_COUNTER = "dp.noised_publishes"  # fedml_dp_noised_publishes_total

DEFAULT_NOISE_MULTIPLIER = 0.8
DEFAULT_L2_CLIP = 1.0
DEFAULT_DELTA = 1e-5
DEFAULT_EPSILON_BUDGET = 8.0
#: the SLO row's firing line: alert BEFORE the budget is actually crossed
BUDGET_ALERT_FRAC = 0.85


def _float_keys(tree: StateDict) -> list:
    return [k for k, v in tree.items() if v.is_floating_point()]


def _split_like(flat: torch.Tensor, tree: StateDict, keys: list) -> StateDict:
    """``flat`` cut into ``keys``' leaves of ``tree`` (shapes and dtypes),
    the other leaves of ``tree`` passed through: one cast of the whole
    vector when the leaves share a dtype, else a cast a leaf."""
    dtypes = {tree[k].dtype for k in keys}
    if len(dtypes) == 1:
        flat = flat.to(dtypes.pop())
    parts = torch.split(flat, [tree[k].numel() for k in keys])
    out = dict(tree)
    for k, part in zip(keys, parts):
        out[k] = part.view(tree[k].shape).to(tree[k].dtype)
    return out


def clip_update(tree: StateDict, l2_clip: float) -> StateDict:
    """Project a client update onto the L2 ball of radius ``l2_clip``: the
    sensitivity bound the Gaussian sigma is calibrated against. Within the
    ball the input comes back untouched; outside, each floating leaf is
    scaled in f32 by ``l2_clip / norm``, as the JAX package does. The norm
    is taken in f64 over the floating leaves as one vector on their device
    (JAX sums it on the host, leaf by leaf), so it can differ from JAX's in
    its last bits and the scaled leaves by an f32 ulp."""
    keys = _float_keys(tree)
    norm = float(torch.linalg.vector_norm(torch.cat([tree[k].reshape(-1) for k in keys]).double()))
    if norm <= float(l2_clip) or norm == 0.0:
        return tree
    scale = float(np.float32(float(l2_clip) / norm))
    return {k: v * scale if v.is_floating_point() else v for k, v in tree.items()}


def _is_nested(tree: Any) -> bool:
    """A flax-layout tree (nested dicts of arrays: the FedLLM client's
    adapters), not a flat state dict."""
    return any(isinstance(v, Mapping) for v in tree.values())


def clip_to_reference(tree: StateDict, reference: StateDict, l2_clip: float) -> StateDict:
    """Clip the UPDATE ``tree - reference`` onto the L2 ball of radius
    ``l2_clip`` and return ``reference + clipped_update``: the enforcement
    point of the sensitivity bound DPFold's sigma is calibrated against.
    Clients upload full trained weights, so the projection is relative to
    the model they trained from (client side: the last received global;
    server side: the current global). Within the ball the input state dict
    is returned untouched (not a reconstruction). Outside, the delta is
    taken in f64 and ``reference + delta * scale`` cast back to each leaf's
    dtype (f32 on the main path), as in the JAX package. The floating leaves
    go through as one flat vector on their device (a few ops, not a few a
    leaf); the norm is summed there in f64 in another order than JAX's host
    sum, so the clipped leaves can differ from JAX's by one f32 ulp.

    Either side may instead be a flax-layout tree of numpy arrays (what the
    FedLLM client exchanges; JAX's function takes any pytree): it is clipped
    as the state dict it converts to and comes back in its own layout."""
    if _is_nested(tree) or _is_nested(reference):
        from ...models.convert import params_from_jax, params_to_jax

        state = params_from_jax(tree) if _is_nested(tree) else tree
        ref = params_from_jax(reference) if _is_nested(reference) else reference
        out = clip_to_reference(state, ref, l2_clip)
        if out is state:
            return tree
        return params_to_jax(out) if _is_nested(tree) else out
    keys = _float_keys(tree)
    dev = tree[keys[0]].device
    x = torch.cat([tree[k].reshape(-1) for k in keys]).double()
    ref = torch.cat([reference[k].reshape(-1) for k in keys]).to(dev).double()
    delta = x.sub_(ref)
    norm = float(torch.linalg.vector_norm(delta))
    if norm <= float(l2_clip) or norm == 0.0:
        return tree
    return _split_like(ref.add_(delta, alpha=float(l2_clip) / norm), tree, keys)


class DPAccountant:
    """RDP/moments accounting for the fold's Gaussian mechanism, plus every
    observability surface the budget must reach."""

    def __init__(self, noise_multiplier: float = DEFAULT_NOISE_MULTIPLIER,
                 delta: float = DEFAULT_DELTA,
                 epsilon_budget: float = DEFAULT_EPSILON_BUDGET,
                 sample_rate: float = 1.0):
        if noise_multiplier <= 0:
            raise ValueError(f"noise_multiplier must be > 0, got {noise_multiplier}")
        self.noise_multiplier = float(noise_multiplier)
        self.delta = float(delta)
        self.epsilon_budget = float(epsilon_budget)
        self.sample_rate = float(sample_rate)
        self._rdp = RDPAccountant()
        self._lock = threading.Lock()
        self.steps = 0
        self.epsilon_spent = 0.0

    def step(self, steps: int = 1) -> float:
        """Account ``steps`` more releases of the mechanism and mark the
        flight recorder. Returns the spent ε at the configured δ."""
        with self._lock:
            self._rdp.step(noise_multiplier=self.noise_multiplier,
                           sample_rate=self.sample_rate, steps=int(steps))
            self.steps += int(steps)
            self.epsilon_spent = float(self._rdp.get_epsilon(self.delta))
            eps, frac = self.epsilon_spent, self.budget_frac_locked()
        flight_recorder.mark("dp.accountant_step", steps=self.steps,
                             epsilon=round(eps, 6), budget_frac=round(frac, 6),
                             noise_multiplier=self.noise_multiplier)
        return eps

    def budget_frac_locked(self) -> float:
        return self.epsilon_spent / self.epsilon_budget if self.epsilon_budget > 0 else 0.0

    def budget_frac(self) -> float:
        with self._lock:
            return self.budget_frac_locked()

    def exhausted(self) -> bool:
        return self.budget_frac() >= 1.0

    def statusz(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "noise_multiplier": self.noise_multiplier,
                "delta": self.delta,
                "sample_rate": self.sample_rate,
                "steps": self.steps,
                "epsilon_spent": self.epsilon_spent,
                "epsilon_budget": self.epsilon_budget,
                "budget_frac": self.budget_frac_locked(),
            }

    def prom_gauges(self) -> List[tuple]:
        with self._lock:
            return [
                ("dp_epsilon_spent", {}, float(self.epsilon_spent)),
                ("dp_budget_frac", {}, float(self.budget_frac_locked())),
            ]

    def tsdb_collector(self, store) -> None:
        """Gauge feed for ``store.add_collector``: the series the
        ``dp_budget_exhaustion`` SLO row watches."""
        with self._lock:
            eps, frac = self.epsilon_spent, self.budget_frac_locked()
        store.record_gauge("privacy.dp_epsilon_spent", float(eps))
        store.record_gauge("privacy.dp_budget_frac", float(frac))


class DPFold:
    """The fold-side mechanism: either the buffer's privacy session itself
    (dp-only mode: scale and noise replace the publish's scale) or the noise
    stage that the secagg unmask and the synchronous round hand their mean
    to."""

    def __init__(self, noise_multiplier: float = DEFAULT_NOISE_MULTIPLIER,
                 l2_clip: float = DEFAULT_L2_CLIP,
                 delta: float = DEFAULT_DELTA,
                 epsilon_budget: float = DEFAULT_EPSILON_BUDGET,
                 sample_rate: float = 1.0, seed: int = 0,
                 accountant: Optional[DPAccountant] = None):
        self.noise_multiplier = float(noise_multiplier)
        self.l2_clip = float(l2_clip)
        self.seed = int(seed)
        self.accountant = accountant or DPAccountant(
            noise_multiplier=noise_multiplier, delta=delta,
            epsilon_budget=epsilon_budget, sample_rate=sample_rate)
        self._generators: Dict[torch.device, torch.Generator] = {}
        self._lock = threading.Lock()

    def _sigma_mean(self, n: float) -> float:
        """Noise std on the MEAN: z * C on the sum, / n after normalize."""
        return self.noise_multiplier * self.l2_clip / float(max(1.0, n))

    def _noise_(self, flat: torch.Tensor, s: float, sigma: float) -> torch.Tensor:
        """``flat * s + sigma * N(0, 1)`` in place on an f32 vector, the
        draws from this fold's generator on ``flat``'s device; then one
        accountant step. ``s`` and ``sigma`` are rounded to f32 first, as
        the JAX package passes them."""
        with self._lock:
            gen = self._generators.get(flat.device)
            if gen is None:
                gen = torch.Generator(device=flat.device)
                gen.manual_seed(self.seed)
                self._generators[flat.device] = gen
            noise = torch.randn(flat.shape, generator=gen, device=flat.device,
                                dtype=torch.float32)
        if s != 1.0:
            flat.mul_(float(np.float32(s)))
        flat.add_(noise, alpha=float(np.float32(sigma)))
        self.accountant.step()
        tel.counter(NOISED_PUBLISH_COUNTER).add(1)
        return flat

    def attach(self, buffer: Any) -> "DPFold":
        """dp-only mode: become the buffer's privacy session."""
        buffer.enable_privacy(self)
        return self

    # --- buffer hook (dp-only mode) -----------------------------------------
    def on_publish(self, acc: torch.Tensor, weight_sum: float, merges: int,
                   template: StateDict, engine: Any) -> StateDict:
        """Scale the streamed raw-weight sum by ``1/W`` and noise it with
        ``z·C/W``, in place, then split it into the template's leaves."""
        self._noise_(acc, 1.0 / weight_sum, self._sigma_mean(weight_sum))
        return engine.finalize(acc, template)

    # --- secagg+dp composition and the synchronous round -------------------
    def noise_flat(self, flat: torch.Tensor, n_members: int) -> torch.Tensor:
        """Noise an already-normalized mean's flat f32 vector (in place)."""
        return self._noise_(flat, 1.0, self._sigma_mean(n_members))

    def noise_tree(self, tree: StateDict, n_members: int) -> StateDict:
        """Noise an already-normalized mean state dict: flattened to one f32
        vector, noised, split back into its leaves and dtypes."""
        keys = list(tree)
        flat = torch.cat([tree[k].reshape(-1) for k in keys]).to(torch.float32)
        self.noise_flat(flat, n_members)
        return _split_like(flat, tree, keys)

    def statusz(self) -> Dict[str, Any]:
        doc = self.accountant.statusz()
        doc["l2_clip"] = self.l2_clip
        return doc

    def prom_gauges(self) -> List[tuple]:
        return self.accountant.prom_gauges()
