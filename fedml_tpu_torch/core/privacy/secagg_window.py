"""Windowed async SecAgg: masking cohorts per AsyncAggBuffer publish window,
the counterpart of ``fedml_tpu/core/privacy/secagg_window.py``
(:class:`WindowMember`, :class:`SecAggWindow`, :class:`WindowCoordinator`
and the hierarchy's :class:`HierarchyPrivacy`).

The cohort unit is one **publish window** of the FedBuff buffer
(``core/aggregation/async_buffer.py``): a window opens at buffer version
``v`` with an explicit member set, members exchange DH public keys and
Shamir shares of their window secret keys, and each member submits
``(quantize(update) + pairwise masks) mod 2^b``, a float32 ring vector that
the buffer folds AT ARRIVAL through the unmodified bucketed engine (weight
1.0, so mask coefficients stay exactly ±1). The masked vector enters the
buffer as a one-entry state dict on the server's device (one host-to-device
copy an arrival), so on the card the ring sum is the engine's f32 matrix-
vector product: integer-exact below 2^24 with TF32 matmuls off, which
:meth:`WindowCoordinator.submit` checks. When the window fills, the publish
reduces the streamed sum mod 2^b and the pairwise masks cancel exactly.
Masking, reveal and unmasking are numpy on the host, as in the JAX package.

Dropout recovery (the mask-share reveal): when members vanish mid-cohort the
window closes *partial* (booked on ``quorum.partial``) by asking survivors
to reveal their Shamir shares of each dropped member's window secret key.
The coordinator reconstructs the dropped key, re-derives its (symmetric)
pair seeds against every survivor, and subtracts the stray masks the
survivors added toward the dead rank; the survivors' sum then unmasks
bit-exactly. Booked on ``secagg.recovered``.

Every vector here is the JAX package's flat vector: the model's leaves in
flax order, kernels in flax layout (``models/convert.py`` ``wire_vector``),
so a port member's masked vector equals a JAX member's for the same weights
and seeds, and a mixed federation unmasks.

Hierarchical masking: :class:`HierarchyPrivacy` scopes one coordinator per
edge node of a ``HierarchyTree`` (members additionally mask with the edge
tier's key, and the edge forwards its window's ring residue still masked,
as a one-entry state dict on its device), leaves regional tiers folding
opaque ring vectors (reduced mod 2^b on the host, one copy down and up a
publish), and gives only the root the :class:`~.masking.TierKeyring`: the
root strips every contributing member's tier mask, centres, dequantizes and
noises. Edge and regional aggregators learn nothing but their tier's masked
sum. Unlike the JAX package, :class:`HierarchyPrivacy` refuses a tree whose
root publish can hold more members than the ring recovers (ROADMAP.md,
Queue 3, R5).

The flight-recorder marks and the Prometheus gauges are not ported; the
counters and ``statusz()`` are.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry as tel
from ..mpc.finite_field import (
    DEFAULT_PRIME,
    dh_public_key,
    dh_shared_key,
    shamir_reconstruct,
    shamir_share,
)
from ..resilience import quorum as quorum_mod
from .masking import (
    QuantSpec,
    center_ring,
    dequantize_sum,
    mask_quantized,
    pair_seed,
    quantize_vector,
    ring_mod,
    stray_mask_correction,
    validate_ring_bits,
)

StateDict = Dict[str, torch.Tensor]

WINDOWS_COUNTER = "secagg.windows"            # fedml_secagg_windows_total
MASKED_MERGE_COUNTER = "secagg.masked_merges"  # fedml_secagg_masked_merges_total
DROPOUT_COUNTER = "secagg.dropouts"           # fedml_secagg_dropouts_total
RECOVERED_COUNTER = "secagg.recovered"        # fedml_secagg_recovered_total
REVEAL_COUNTER = "secagg.reveals"             # fedml_secagg_reveals_total
WINDOWS_FAILED_COUNTER = "secagg.windows_failed"  # fedml_secagg_windows_failed_total

#: verdict for a masked arrival addressed to an already-closed window: the
#: stray masks it carries were already revealed and subtracted, so folding
#: it would corrupt the sum AND void its privacy
WINDOW_CLOSED = "window_closed"

#: the one-entry state dict a masked ring vector folds as
MASKED_LEAF = "masked"

_DH_PRIME = 2**31 - 1
_DH_GENERATOR = 5


def _require_exact_fold(device: torch.device) -> None:
    """The ring sum is exact only while every f32 product and partial sum
    of the fold is: TF32 matmuls round the ring values to 10 mantissa
    bits, so the masks would no longer cancel."""
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "privacy=secagg: torch.backends.cuda.matmul.allow_tf32 is on, and the "
            "bucketed fold of masked ring vectors is integer-exact only in full f32 "
            "matmuls; turn TF32 matmuls off")


class WindowMember:
    """One cohort member's client-side window state: its DH keypair, the
    Shamir shares it deals/holds, its derived pair seeds, and the masking
    entry point. Lives client-side — the coordinator never reads
    ``secret_key`` except through the reveal protocol."""

    def __init__(self, rank: int, window_id: int, nonce: int,
                 cohort: Sequence[int], spec: QuantSpec, threshold: int,
                 tier_key: Optional[int] = None,
                 rng: Optional[np.random.Generator] = None):
        self.rank = int(rank)
        self.window_id = int(window_id)
        self.nonce = int(nonce)
        self.cohort = sorted(int(r) for r in cohort)
        if self.rank not in self.cohort:
            raise ValueError(f"rank {rank} not in cohort {self.cohort}")
        self.spec = spec
        self.threshold = int(threshold)
        self.tier_key = tier_key
        self._rng = rng or np.random.default_rng()
        self.secret_key = int(self._rng.integers(2, _DH_PRIME - 1))
        self.public_key = dh_public_key(self.secret_key, _DH_PRIME,
                                        _DH_GENERATOR)
        self._peer_pks: Dict[int, int] = {}
        self._pair_seeds: Dict[int, int] = {}
        self._held_shares: Dict[int, np.ndarray] = {}  # dealer rank -> share
        self.submitted = False

    # --- key exchange -------------------------------------------------------
    def install_directory(self, pks: Dict[int, int]) -> None:
        """Learn every peer's public key and derive the per-window pair
        seeds (symmetric in the pair, fresh per window via the nonce)."""
        self._peer_pks = {int(r): int(pk) for r, pk in pks.items()
                          if int(r) != self.rank}
        self._pair_seeds = {
            r: pair_seed(self.nonce, dh_shared_key(self.secret_key, pk,
                                                   _DH_PRIME))
            for r, pk in self._peer_pks.items()}

    def deal_shares(self) -> Dict[int, np.ndarray]:
        """Shamir shares of this member's window secret key, one per cohort
        member (dealer keeps its own)."""
        shares = shamir_share(np.asarray([self.secret_key], np.int64),
                              len(self.cohort), self.threshold,
                              DEFAULT_PRIME, self._rng)
        return {peer: shares[i] for i, peer in enumerate(self.cohort)}

    def receive_share(self, dealer_rank: int, share: np.ndarray) -> None:
        self._held_shares[int(dealer_rank)] = np.asarray(share, np.int64)

    # --- masking ------------------------------------------------------------
    def mask(self, delta_vec: np.ndarray) -> np.ndarray:
        """Quantize a flat f32 delta onto the shared grid and mask it into
        the ring — the only form of this member's update that ever leaves
        the client."""
        if len(self._pair_seeds) != len(self.cohort) - 1:
            raise RuntimeError(
                f"rank {self.rank}: key directory incomplete "
                f"({len(self._pair_seeds)}/{len(self.cohort) - 1} peers)")
        q = quantize_vector(np.asarray(delta_vec), self.spec)
        self.submitted = True
        return mask_quantized(q, self.rank, self._pair_seeds, self.spec,
                              tier_key=self.tier_key,
                              window_nonce=self.nonce)

    # --- recovery -----------------------------------------------------------
    def reveal_shares(self, dropped: Sequence[int]) -> Dict[int, List[int]]:
        """The mask-share reveal: this survivor's held shares of each
        dropped member's window key. The only client-side refusal is this
        member's OWN rank — a client cannot observe whether a *peer*
        submitted, so it cannot police the server's dropped set. A server
        that equivocates (lists a submitted client as dropped) collects
        enough shares to unmask that client's individual update; this
        design has no Bonawitz-style self-mask, so the server is TRUSTED
        not to equivocate on the dropped set (docs/privacy.md §threat
        model)."""
        out: Dict[int, List[int]] = {}
        for dr in dropped:
            dr = int(dr)
            if dr == self.rank:
                continue
            share = self._held_shares.get(dr)
            if share is not None:
                out[dr] = [int(v) for v in np.asarray(share).ravel()]
        return out


class SecAggWindow:
    """Server-side state of one masking cohort: who is expected, who
    arrived, the public-key directory, and the reveal bookkeeping for a
    partial close. Holds no secrets — only public keys and revealed
    shares."""

    def __init__(self, window_id: int, nonce: int, cohort: Sequence[int],
                 spec: QuantSpec, threshold: int):
        self.window_id = int(window_id)
        self.nonce = int(nonce)
        self.cohort = sorted(int(r) for r in cohort)
        self.spec = spec
        self.threshold = int(threshold)
        self.public_keys: Dict[int, int] = {}
        self.arrived: List[int] = []
        self.opened_mono = time.monotonic()
        self.closed = False
        self.recovered = False
        self._reveals: Dict[int, Dict[int, np.ndarray]] = {}  # dropped -> {survivor: share}

    def register_public_key(self, rank: int, pk: int) -> None:
        self.public_keys[int(rank)] = int(pk)

    def note_arrival(self, rank: int) -> None:
        r = int(rank)
        if r not in self.arrived:
            self.arrived.append(r)

    def missing(self) -> List[int]:
        return [r for r in self.cohort if r not in self.arrived]

    def complete(self) -> bool:
        return not self.missing()

    def add_reveal(self, survivor: int, shares: Dict[int, Sequence[int]]) -> None:
        """One survivor's share bundle from the reveal phase."""
        for dr, share in shares.items():
            self._reveals.setdefault(int(dr), {})[int(survivor)] = \
                np.asarray(list(share), np.int64)
        tel.counter(REVEAL_COUNTER).add(1)

    def reveals_complete(self) -> bool:
        dropped = self.missing()
        if not dropped:
            return True
        for dr in dropped:
            if len(self._reveals.get(dr, {})) < self.threshold + 1:
                return False
        return True

    def correction(self, d: int) -> np.ndarray:
        """The stray-mask correction vector for a partial close: Shamir-
        reconstruct each dropped member's window key from the revealed
        shares, re-derive its symmetric pair seeds against every survivor,
        and total the signed masks the survivors added toward it."""
        dropped_seeds: Dict[int, Dict[int, int]] = {}
        for dr in self.missing():
            bundle = self._reveals.get(dr, {})
            if len(bundle) < self.threshold + 1:
                raise RuntimeError(
                    f"window {self.window_id}: {len(bundle)} reveals for "
                    f"dropped rank {dr}, need {self.threshold + 1}")
            idx = sorted(self.cohort.index(s) for s in bundle)
            shares = np.stack([bundle[self.cohort[i]] for i in idx])
            sk = int(shamir_reconstruct(shares, idx, DEFAULT_PRIME)[0])
            dropped_seeds[dr] = {
                j: pair_seed(self.nonce,
                             dh_shared_key(sk, self.public_keys[j], _DH_PRIME))
                for j in self.arrived}
        return stray_mask_correction(dropped_seeds, self.arrived, d, self.spec)

    def statusz(self) -> Dict[str, Any]:
        return {
            "window_id": self.window_id,
            "cohort": list(self.cohort),
            "arrived": list(self.arrived),
            "missing": self.missing(),
            "closed": self.closed,
            "recovered": self.recovered,
            "reveals": {dr: sorted(b) for dr, b in self._reveals.items()},
        }


class WindowCoordinator:
    """The buffer-attached privacy session: opens masking windows over an
    :class:`AsyncAggBuffer`, folds masked ring vectors at arrival, and (as
    the buffer's ``on_publish`` hook) unmasks the window sum exactly where
    the plain path would normalize, dequantizes it to the model's state
    dict, and applies DP noise when a :class:`~.dp.DPFold` is wired.

    ``template`` is the global model's state dict: it fixes the flat
    vector's length and order (the JAX wire layout) and the device the
    masked arrivals fold on. ``support_ratio`` composes the window with the
    sparse uplink: each window derives a nonce-seeded shared rand-k support
    (``utils/compression.py`` ``secagg_support``) that shrinks the masking
    domain to k coordinates cohort-wide; publish scatters the unmasked mean
    back dense (zeros off the support).

    Roles by construction arguments:

    * flat window (default): publish unmasks, dequantizes to the model
      state dict, and applies DP noise when a :class:`~.dp.DPFold` is wired;
    * edge tier (``tier_key`` set): members add the tier mask, publish
      appends ``{tier, nonce, ranks, n}`` to the shared ``ledger`` and
      forwards the still-masked ring residue up the hierarchy as
      ``{MASKED_LEAF: f32 tensor}`` on this coordinator's device;
      ``max_fanin`` is the tree's largest fold, which bounds the ring;
    * regional pass-through and root unmask live in
      :class:`HierarchyPrivacy`."""

    def __init__(self, buffer: Any, template: StateDict,
                 spec: Optional[QuantSpec] = None,
                 threshold: Optional[int] = None,
                 dp: Optional[Any] = None,
                 tier_name: Optional[str] = None,
                 tier_key: Optional[int] = None,
                 ledger: Optional[List[Dict[str, Any]]] = None,
                 max_fanin: Optional[int] = None,
                 support_ratio: Optional[float] = None,
                 rng: Optional[np.random.Generator] = None):
        self.buffer = buffer
        self.dp = dp
        self.tier_name = tier_name
        self.tier_key = tier_key
        self.ledger = ledger  # shared across tiers by HierarchyPrivacy
        self._rng = rng or np.random.default_rng()
        # shapes, dtypes and names only: the publish unflattens into these
        self._template = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                          for k, v in template.items()}
        self._device = next(iter(template.values())).device
        self.full_d = int(sum(v.numel() for v in template.values()))
        # per window, because the support is part of the mask schedule: it
        # MUST be derived from the window nonce
        self.support_ratio = support_ratio
        self.support: Optional[np.ndarray] = None
        self.d = self.full_d
        self.spec = spec or QuantSpec()
        self.threshold = threshold
        self.window: Optional[SecAggWindow] = None
        self.closed_windows: set = set()
        self.windows_total = 0
        self.recovered_total = 0
        self.dropouts_total = 0
        self.failed_total = 0
        self._max_fanin = max_fanin
        self._lock = threading.Lock()
        if getattr(buffer.policy, "exponent", 0.0) != 0.0:
            raise ValueError(
                "secagg windows need StalenessPolicy(exponent=0): a decayed "
                "fold weight would scale the masks and break cancellation")
        buffer.enable_privacy(self)

    # --- window lifecycle ---------------------------------------------------
    def open_window(self, cohort: Sequence[int],
                    run_key_exchange: bool = True
                    ) -> Tuple[SecAggWindow, Dict[int, WindowMember]]:
        """Open the masking cohort for the buffer's CURRENT publish window
        and (in-process convenience) run the key-exchange and share-dealing
        rounds among freshly built members. Cross-silo drivers pass
        ``run_key_exchange=False`` and move the same payloads over the
        message plane."""
        _require_exact_fold(self._device)
        cohort = sorted(int(r) for r in cohort)
        n = len(cohort)
        validate_ring_bits(self.spec, self._max_fanin or n, n)
        threshold = self.threshold if self.threshold is not None else n // 2
        if threshold + 1 > n:
            raise ValueError(f"threshold {threshold} unreachable with {n} members")
        window_id = int(self.buffer.version)
        nonce = int(self._rng.integers(1, 2**62))
        if self.support_ratio is not None:
            from ...utils.compression import secagg_support

            self.support = secagg_support(nonce, self.full_d, self.support_ratio)
            self.d = int(self.support.size)
        window = SecAggWindow(window_id, nonce, cohort, self.spec, threshold)
        members: Dict[int, WindowMember] = {}
        if run_key_exchange:
            members = {
                r: WindowMember(r, window_id, nonce, cohort, self.spec, threshold,
                                tier_key=self.tier_key,
                                rng=np.random.default_rng(self._rng.integers(2**62)))
                for r in cohort}
            for r, m in members.items():
                window.register_public_key(r, m.public_key)
            directory = {r: m.public_key for r, m in members.items()}
            for m in members.values():
                m.install_directory(directory)
            for r, m in members.items():
                for peer, share in m.deal_shares().items():
                    members[peer].receive_share(r, share)
        with self._lock:
            self.window = window
            self.windows_total += 1
        tel.counter(WINDOWS_COUNTER).add(1)
        return window, members

    def submit(self, rank: int, masked_vec: Any,
               client_version: Optional[int] = None,
               window_id: Optional[int] = None) -> str:
        """Fold one masked arrival (weight 1.0: the mask-cancellation
        invariant) and book it against the open window. The ring vector
        (numpy, or a CPU tensor from a byte backend) goes to the server's
        device in one copy and folds as a one-entry state dict. Arrivals for
        a closed window are refused: their stray masks were already
        revealed. Arrivals carrying a ``window_id`` that is not the open
        window's are refused too: a straggler masked under a stale window's
        seeds would fold un-cancellable masks into the new window's sum."""
        with self._lock:
            window = self.window
        if window is None or window.closed:
            tel.counter(quorum_mod.LATE_COUNTER).add(1)
            return WINDOW_CLOSED
        if window_id is not None and int(window_id) != window.window_id:
            tel.counter(quorum_mod.LATE_COUNTER).add(1)
            return WINDOW_CLOSED
        if int(rank) not in window.cohort:
            return quorum_mod.STALE_REJECTED
        _require_exact_fold(self._device)
        with tel.span("secagg.submit", rank=int(rank), window=window.window_id):
            vec = torch.as_tensor(np.asarray(masked_vec, np.float32)).to(self._device)
            verdict = self.buffer.submit(int(rank), {MASKED_LEAF: vec}, 1.0, client_version)
        if verdict in (quorum_mod.ACCEPT, quorum_mod.STALE_ACCEPTED):
            window.note_arrival(rank)
            tel.counter(MASKED_MERGE_COUNTER).add(1)
        return verdict

    # --- dropout recovery ---------------------------------------------------
    def recover(self, members: Optional[Dict[int, WindowMember]] = None,
                reveals: Optional[Dict[int, Dict[int, Sequence[int]]]] = None
                ) -> List[int]:
        """Run the mask-share reveal for the open window's missing members.
        In process: pull each survivor's shares straight off its
        ``WindowMember``; cross-silo passes ``reveals`` collected over the
        message plane (survivor -> {dropped: share}), or nothing when the
        server manager has already added them to the window."""
        window = self.window
        if window is None:
            return []
        dropped = window.missing()
        if not dropped:
            return []
        tel.counter(DROPOUT_COUNTER).add(len(dropped))
        if reveals is None and members is not None:
            reveals = {s: members[s].reveal_shares(dropped)
                       for s in window.arrived if s in members}
        for survivor, bundle in (reveals or {}).items():
            window.add_reveal(survivor, bundle)
        if not window.reveals_complete():
            raise RuntimeError(
                f"window {window.window_id}: reveal quorum not met for "
                f"dropped ranks {dropped}")
        return dropped

    def abort_window(self) -> List[int]:
        """Give up on the open window: too many cohort members are gone to
        ever meet the reveal quorum. The buffer's accumulated epoch is
        DISCARDED (it still carries the survivors' un-cancellable stray
        masks, so publishing it would emit masked garbage) and the window is
        marked closed, so any straggler arrival gets the ``window_closed``
        refusal. Returns the missing ranks; booked on
        ``secagg.windows_failed``."""
        with self._lock:
            window = self.window
            self.window = None
            if window is None:
                return []
            window.closed = True
            self.closed_windows.add(window.window_id)
            self.failed_total += 1
        missing = window.missing()
        self.buffer.discard()
        tel.counter(WINDOWS_FAILED_COUNTER).add(1)
        return missing

    def close_window(self) -> Optional[StateDict]:
        """Force-publish a partial window after recovery (the quorum's
        partial close: deadline hit, survivors counted, stray masks
        corrected). Publishing through the buffer keeps the version and
        interval bookkeeping identical to a full window."""
        window = self.window
        if window is None:
            return None
        if not window.complete():
            tel.counter(quorum_mod.PARTIAL_COUNTER).add(1)
        return self.buffer.publish()

    # --- buffer hook --------------------------------------------------------
    def on_publish(self, acc: torch.Tensor, weight_sum: float, merges: int,
                   template: Any, engine: Any) -> StateDict:
        """Unmask at the exact point the plain path normalizes. ``acc`` is
        the engine's streamed f32 sum of masked ring vectors on the server's
        device, integer-exact by the masking domain contract. One
        device-to-host copy of it; the mod 2^b, the stray-mask correction,
        the centering and the dequantization run in f64 on the host; the
        dequantized mean goes back to the device in one copy, where DP noise
        (secagg+dp) is added to the flat vector before it is split into the
        model's leaves. An edge tier stops after the mod 2^b and the stray-
        mask correction: its ring residue goes up still tier-masked, one copy
        back to the device, and the ledger says what the root must strip."""
        window = self.window
        with tel.span("secagg.unmask", window=-1 if window is None else window.window_id):
            flat = acc.detach().cpu().numpy().astype(np.float64)
            residue = ring_mod(flat, self.spec)
            n_members = merges
            if window is not None:
                dropped = window.missing()
                if dropped:
                    residue = ring_mod(residue - window.correction(self.d), self.spec)
                    window.recovered = True
                    with self._lock:
                        self.recovered_total += 1
                        self.dropouts_total += len(dropped)
                    tel.counter(RECOVERED_COUNTER).add(1)
                n_members = len(window.arrived)
                window.closed = True
                self.closed_windows.add(window.window_id)
            if self.tier_key is not None:
                if self.ledger is not None and window is not None:
                    self.ledger.append({
                        "tier": self.tier_name, "nonce": window.nonce,
                        "ranks": list(window.arrived), "n": n_members})
                return {MASKED_LEAF: torch.from_numpy(residue.astype(np.float32))
                        .to(self._device)}
            signed = center_ring(residue, self.spec)
            out_vec = dequantize_sum(signed, n_members, self.spec)
            if self.support is not None:
                dense = np.zeros(self.full_d, np.float32)
                dense[self.support] = out_vec
                out_vec = dense
            vec = torch.from_numpy(out_vec).to(self._device)
        if self.dp is not None:
            self.dp.noise_flat(vec, n_members)
        from ...models.convert import state_from_wire_vector

        return state_from_wire_vector(vec, self._template)

    # --- introspection ------------------------------------------------------
    def statusz(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "tier": self.tier_name or "flat",
                "spec": self.spec.as_dict(),
                "windows_total": self.windows_total,
                "recovered_total": self.recovered_total,
                "dropouts_total": self.dropouts_total,
                "failed_total": self.failed_total,
                "open_window": self.window.statusz() if self.window else None,
            }


class HierarchyPrivacy:
    """Per-tier masking over a ``HierarchyTree``: one masking coordinator
    per edge (members mask with that edge's tier key), opaque ring folding
    at regional tiers, and root-side tier-key unmasking.

    The regional and root buffers fold weight-1.0 submissions of ring
    vectors (the tree forwards privacy publishes at unit weight) on the
    tree's device, and their publish hooks only re-reduce mod 2^b: exact,
    by the fan-in bound checked at construction. Draws: ``root_secret``
    first, then one child generator per edge in edge order, as in the JAX
    package, so the same ``rng`` gives the same masks in both.

    Unlike the JAX package (whose ``open_window`` checks the ring against
    one edge's cohort only), construction refuses a tree whose root publish
    can sum more members than the ring recovers: root ``publish_k`` x the
    largest regional ``publish_k`` x the largest edge ``publish_k``
    (ROADMAP.md, Queue 3, R5); :meth:`open_edge_windows` holds each cohort
    to the same bound."""

    def __init__(self, tree: Any, template: StateDict,
                 spec: Optional[QuantSpec] = None,
                 threshold: Optional[int] = None,
                 dp: Optional[Any] = None,
                 rng: Optional[np.random.Generator] = None):
        from .masking import TierKeyring

        device = next(iter(template.values())).device
        if getattr(tree, "device", None) is not None and device != tree.device:
            raise ValueError(f"the template lies on {device}, and the tree folds on "
                             f"{tree.device}")
        self.tree = tree
        self._rng = rng or np.random.default_rng()
        self.ledger: List[Dict[str, Any]] = []
        self.keyring = TierKeyring.generate(
            [e.name for e in tree.edges],
            root_secret=int(self._rng.integers(1, 2**62)))
        max_fanin = max([len(tree.edges)] +
                        [n.buffer.publish_k for n in tree.nodes()])
        self.spec = spec or QuantSpec()
        # the members one root publish can sum: root window x regional
        # window x edge window, each at its largest
        self._upstream = tree.root.buffer.publish_k * max(
            [n.buffer.publish_k for n in tree.regionals] or [1])
        self.max_members = self._upstream * max(e.buffer.publish_k for e in tree.edges)
        self._check_ring(max_fanin, self.max_members)
        self._max_fanin = max_fanin
        self.edge_coordinators: Dict[str, WindowCoordinator] = {}
        for edge in tree.edges:
            co = WindowCoordinator(
                edge.buffer, template, spec=self.spec, threshold=threshold,
                tier_name=edge.name, tier_key=self.keyring.key_for(edge.name),
                ledger=self.ledger, max_fanin=max_fanin,
                rng=np.random.default_rng(self._rng.integers(2**62)))
            self.edge_coordinators[edge.name] = co
            edge.privacy = co
        for node in tree.regionals:
            node.privacy = _RingPassThrough(node.buffer, self.spec)
        self.root_unmasker = _RootUnmasker(
            tree.root.buffer, template, self.spec, self.keyring,
            self.ledger, dp=dp)
        tree.root.privacy = self.root_unmasker

    def _check_ring(self, max_fanin: int, members: int) -> None:
        try:
            validate_ring_bits(self.spec, max_fanin, members)
        except ValueError as e:
            raise ValueError(
                f"hierarchical masking: one root publish can sum {members} members "
                f"(root x regional x edge windows); {e}") from None

    def open_edge_windows(self, cohorts: Dict[str, Sequence[int]]
                          ) -> Dict[str, Tuple[SecAggWindow, Dict[int, WindowMember]]]:
        """Open one masking window per edge name -> cohort ranks. A cohort
        larger than its edge's window must still fit the ring at the root."""
        for ranks in cohorts.values():
            self._check_ring(self._max_fanin, self._upstream * len(list(ranks)))
        return {name: self.edge_coordinators[name].open_window(ranks)
                for name, ranks in cohorts.items()}

    def statusz(self) -> Dict[str, Any]:
        return {
            "edges": {n: c.statusz() for n, c in self.edge_coordinators.items()},
            "ledger_depth": len(self.ledger),
            "max_members": self.max_members,
        }


class _RingPassThrough:
    """Regional-tier session: publish re-reduces the fold of masked edge
    sums mod 2^b (one copy down, f64 on the host, one copy back) and
    forwards it: the tier never learns more than the masked sum of its
    subtree."""

    def __init__(self, buffer: Any, spec: QuantSpec):
        self.spec = spec
        buffer.enable_privacy(self)

    def before_fold(self, model: StateDict) -> None:
        """Called by the tree before a child's forward folds here."""
        _require_exact_fold(model[MASKED_LEAF].device)

    def on_publish(self, acc: torch.Tensor, weight_sum: float, merges: int,
                   template: Any, engine: Any) -> StateDict:
        with tel.span("secagg.ring_pass", merges=int(merges)):
            flat = acc.detach().cpu().numpy().astype(np.float64)
            residue = ring_mod(flat, self.spec).astype(np.float32)
            return {MASKED_LEAF: torch.from_numpy(residue).to(acc.device)}


class _RootUnmasker:
    """Root-tier session: strip every contributing member's tier mask (the
    ledger names them), center, dequantize by the members' count, DP-noise
    the flat vector on the device and split it into the model's leaves."""

    def __init__(self, buffer: Any, template: StateDict, spec: QuantSpec,
                 keyring: Any, ledger: List[Dict[str, Any]],
                 dp: Optional[Any] = None):
        self.spec = spec
        self.keyring = keyring
        self.ledger = ledger
        self.dp = dp
        self._template = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                          for k, v in template.items()}
        self._device = next(iter(template.values())).device
        buffer.enable_privacy(self)

    def before_fold(self, model: StateDict) -> None:
        """Called by the tree before a child's forward folds here."""
        _require_exact_fold(model[MASKED_LEAF].device)

    def on_publish(self, acc: torch.Tensor, weight_sum: float, merges: int,
                   template: Any, engine: Any) -> StateDict:
        with tel.span("secagg.root_unmask", merges=int(merges)):
            flat = acc.detach().cpu().numpy().astype(np.float64)
            residue = ring_mod(flat, self.spec)
            entries, self.ledger[:] = list(self.ledger), []
            contributions = [(e["tier"], e["nonce"], r)
                             for e in entries for r in e["ranks"]]
            n_total = sum(int(e["n"]) for e in entries) or merges
            residue = self.keyring.strip(residue, contributions, self.spec)
            signed = center_ring(residue, self.spec)
            vec = torch.from_numpy(dequantize_sum(signed, n_total, self.spec)).to(self._device)
        if self.dp is not None:
            self.dp.noise_flat(vec, n_total)
        from ...models.convert import state_from_wire_vector

        return state_from_wire_vector(vec, self._template)
