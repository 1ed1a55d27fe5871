"""Privacy subsystem: windowed async SecAgg and accounted DP at the server
fold, the counterpart of ``fedml_tpu/core/privacy``.

Everything sits behind ``args.privacy``:

* ``"secagg"``      — masking cohorts per async publish window
  (:mod:`secagg_window`), quantized-ring masks that fold through the
  unmodified bucketed engine and cancel exactly at publish;
* ``"dp"``          — Gaussian noise drawn on the fold's device into the
  publish's flat accumulator (async) or the round's mean (sync), with an
  RDP accountant (:mod:`dp`);
* ``"secagg+dp"``   — masked windows whose unmasked mean is noised and
  accounted;
* unset/empty       — the paths are untouched: bit-exact FedAvg.

See docs/privacy.md for the threat model, the window protocol and the
accountant math. Per-tier hierarchical masking (``HierarchyPrivacy``) runs
over the in-process edge->regional->root tree
(``core/distributed/hierarchy.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

from .dp import (
    BUDGET_ALERT_FRAC,
    DEFAULT_DELTA,
    DEFAULT_EPSILON_BUDGET,
    DEFAULT_L2_CLIP,
    DEFAULT_NOISE_MULTIPLIER,
    DPAccountant,
    DPFold,
    clip_to_reference,
    clip_update,
)
from .masking import (
    DEFAULT_CLIP,
    DEFAULT_QBITS,
    QuantSpec,
    TierKeyring,
    ring_bits_for,
)
from .secagg_window import (
    DROPOUT_COUNTER,
    MASKED_MERGE_COUNTER,
    RECOVERED_COUNTER,
    REVEAL_COUNTER,
    WINDOW_CLOSED,
    WINDOWS_COUNTER,
    WINDOWS_FAILED_COUNTER,
    HierarchyPrivacy,
    SecAggWindow,
    WindowCoordinator,
    WindowMember,
)

__all__ = [
    "PrivacyConfig",
    "PrivacyError",
    "privacy_from_args",
    "outbound_delta",
    "is_masked_payload",
    "masked_uplink_payload",
    "submit_masked_payload",
    "SECAGG_PAYLOAD_KEY",
    "QuantSpec",
    "TierKeyring",
    "ring_bits_for",
    "SecAggWindow",
    "WindowCoordinator",
    "WindowMember",
    "HierarchyPrivacy",
    "DPFold",
    "DPAccountant",
    "clip_update",
    "clip_to_reference",
    "WINDOW_CLOSED",
    "WINDOWS_COUNTER",
    "WINDOWS_FAILED_COUNTER",
    "MASKED_MERGE_COUNTER",
    "DROPOUT_COUNTER",
    "RECOVERED_COUNTER",
    "REVEAL_COUNTER",
    "BUDGET_ALERT_FRAC",
]

#: wire marker for a masked uplink payload (mirrors utils.compression's
#: COMM_PAYLOAD_KEY discipline: a dict the server routes by key, never a
#: raw tree)
SECAGG_PAYLOAD_KEY = "__fedml_secagg_masked__"

_VALID_MODES = {"secagg", "dp"}


class PrivacyError(RuntimeError):
    """A privacy-mode invariant was violated at runtime (e.g. a raw client
    delta reached a comm-boundary send while masking was enabled)."""


@dataclass(frozen=True)
class PrivacyConfig:
    """Parsed ``args.privacy`` plus every knob the subsystem reads."""

    secagg: bool = False
    dp: bool = False
    # secagg knobs
    qbits: int = DEFAULT_QBITS
    clip: float = DEFAULT_CLIP
    threshold: Optional[int] = None
    window_deadline_s: float = 30.0
    #: how many times the server may extend a below-quorum window deadline
    #: before aborting the window (discard epoch, reopen over the live cohort)
    window_max_extensions: int = 3
    # dp knobs
    noise_multiplier: float = DEFAULT_NOISE_MULTIPLIER
    l2_clip: float = DEFAULT_L2_CLIP
    delta: float = DEFAULT_DELTA
    epsilon_budget: float = DEFAULT_EPSILON_BUDGET
    sample_rate: float = 1.0
    dp_seed: int = 0

    @property
    def enabled(self) -> bool:
        return self.secagg or self.dp

    @property
    def mode(self) -> str:
        parts = [m for m, on in (("secagg", self.secagg), ("dp", self.dp)) if on]
        return "+".join(parts)

    @classmethod
    def from_args(cls, args: Any) -> "PrivacyConfig":
        raw = str(getattr(args, "privacy", None) or "").strip().lower()
        modes = {m for m in raw.replace(",", "+").split("+") if m}
        unknown = modes - _VALID_MODES
        if unknown:
            raise ValueError(
                f"args.privacy={raw!r}: unknown mode(s) {sorted(unknown)}; "
                "expected secagg | dp | secagg+dp")
        return cls(
            secagg="secagg" in modes,
            dp="dp" in modes,
            qbits=int(getattr(args, "secagg_qbits", DEFAULT_QBITS)),
            clip=float(getattr(args, "secagg_clip", DEFAULT_CLIP)),
            threshold=getattr(args, "secagg_threshold", None),
            window_deadline_s=float(getattr(args, "secagg_window_deadline_s", 30.0)),
            window_max_extensions=int(getattr(args, "secagg_window_max_extensions", 3)),
            noise_multiplier=float(getattr(args, "dp_noise_multiplier",
                                           DEFAULT_NOISE_MULTIPLIER)),
            l2_clip=float(getattr(args, "dp_l2_clip", DEFAULT_L2_CLIP)),
            delta=float(getattr(args, "dp_delta", DEFAULT_DELTA)),
            epsilon_budget=float(getattr(args, "dp_epsilon_budget",
                                         DEFAULT_EPSILON_BUDGET)),
            sample_rate=float(getattr(args, "dp_sample_rate", 1.0)),
            dp_seed=int(getattr(args, "dp_seed", 0)),
        )

    def quant_spec(self, max_fanin: int, total_members: int) -> QuantSpec:
        return QuantSpec(clip=self.clip, qbits=self.qbits,
                         ring_bits=ring_bits_for(max_fanin, total_members,
                                                 self.qbits))

    def build_dp(self) -> Optional[DPFold]:
        if not self.dp:
            return None
        return DPFold(noise_multiplier=self.noise_multiplier,
                      l2_clip=self.l2_clip, delta=self.delta,
                      epsilon_budget=self.epsilon_budget,
                      sample_rate=self.sample_rate, seed=self.dp_seed)

    def as_dict(self) -> Dict[str, Any]:
        return {"mode": self.mode or "off", "qbits": self.qbits,
                "clip": self.clip, "noise_multiplier": self.noise_multiplier,
                "delta": self.delta, "epsilon_budget": self.epsilon_budget}


def privacy_from_args(args: Any) -> PrivacyConfig:
    return PrivacyConfig.from_args(args)


def is_masked_payload(payload: Any) -> bool:
    return isinstance(payload, dict) and bool(payload.get(SECAGG_PAYLOAD_KEY))


def outbound_delta(payload: Any, args: Any = None,
                   cfg: Optional[PrivacyConfig] = None) -> Any:
    """The sanctioned comm-boundary gate for client->server model payloads.

    Every client-side send of model params/deltas routes its payload
    through here. At runtime it is the teeth of the masking contract:
    with a secagg mode enabled, an unmasked tree at the boundary raises
    instead of leaking."""
    cfg = cfg or PrivacyConfig.from_args(args)
    if cfg.secagg and not is_masked_payload(payload):
        raise PrivacyError(
            "privacy=secagg: a raw (unmasked) client delta reached the comm "
            "boundary — mask through WindowMember.mask()/the masked uplink "
            "before sending")
    return payload


def masked_uplink_payload(member: WindowMember, tree: Any,
                          support: Any = None) -> Dict[str, Any]:
    """Client-side masked uplink: flatten the update (a state dict, in the
    JAX package's flat wire order: ``models/convert.py`` ``wire_vector``,
    one device-to-host copy), gather the window's
    shared sparse support when one is set (``utils.compression.
    secagg_support`` — same k coordinates cohort-wide, so masks cancel
    coordinate-wise and the compression ratio survives masking), then
    quantize + mask. The returned dict is the ONLY form of the update that
    crosses the comm boundary; :func:`outbound_delta` accepts it."""
    from ...models.convert import wire_vector

    flat = wire_vector(tree).cpu().numpy()
    vec = flat[np.asarray(support, np.int64)] if support is not None else flat
    return {SECAGG_PAYLOAD_KEY: True,
            "window_id": member.window_id,
            "rank": member.rank,
            "masked": member.mask(vec)}


def submit_masked_payload(coordinator: WindowCoordinator,
                          payload: Dict[str, Any],
                          client_version: Optional[int] = None) -> str:
    """Server-side routing: a masked uplink payload into the open window."""
    if not is_masked_payload(payload):
        raise PrivacyError("not a masked secagg uplink payload")
    window_id = payload.get("window_id")
    return coordinator.submit(int(payload["rank"]), payload["masked"],
                              client_version=client_version,
                              window_id=None if window_id is None else int(window_id))
