"""Server-side aggregation state for cross-silo FL: the synchronous path of
``fedml_tpu/cross_silo/server/fedml_aggregator.py``.

Reference: ``cross_silo/server/fedml_aggregator.py:13`` (add_local_trained_
result, check_whether_all_receive, aggregate:78, client sampling + test).
The aggregation itself delegates to the alg-frame hooks and the bucketed
fold (the port's ``ServerAggregator``, whose hooks refuse the middleware).

An arrival is ingested at the comm boundary: a state dict of CPU tensors
(what a byte backend delivers) goes up to the server's device with one
host-to-device copy per dtype group (``utils/pytree.py`` ``tree_to_device``,
the counterpart of ``tree_from_numpy``); tensors already on a device (an
INMEMORY client's upload) pass through.

The fleet view (``FleetTelemetry``, JAX ``:69-70``, ``:320-330``): each
client's telemetry delta, shipped on its upload, merges into :attr:`fleet`,
whose health tracker the quorum rounds' adaptive deadline and
over-provisioning read.

Async (non-barrier) rounds (``async_rounds``): arrivals fold into the
FedBuff buffer (``core/aggregation/async_buffer.py``, built by
``buffer_from_args`` with the fleet's health tracker, so a flagged straggler
gets the staleness grace) as they come, through :meth:`submit_async_result`,
and :meth:`publish_async` installs each published model.

Privacy (``privacy``: ``secagg``, ``dp`` or ``secagg+dp``; JAX ``:94-135``,
``core/privacy``): with ``secagg`` a ``WindowCoordinator`` becomes the
async buffer's privacy session (masked ring vectors fold at arrival and
unmask at publish; the server manager drives the window protocol), over the
window's shared rand-k support when the clients run ``comm_compressor``
topk or eftopk; with ``dp`` alone a ``DPFold`` is the session (async: every
arrival re-clipped against the current global, the publish noised) or, on
the synchronous path, every arrival of a round is clipped against the
global it trained from and the round's mean noised; with ``secagg+dp`` the
unmasked mean is noised (the masked arrivals cannot be re-clipped here, so
epsilon rests on the clients' clip).

Modelwatch (JAX ``:124-146``, ``:252-313``), on unless
``FEDML_MODELWATCH=0`` or ``modelwatch_disable`` and off under secagg (the
masked vectors are one-time-pad noise to it): the fleet's contribution
ledger is the process's active one; the synchronous round screens its
cohort by sender rank before the DP clip (``modelwatch_quarantine`` drops
outliers and NaN uploads) and folds its rows into the ledger once the new
global is set; the async buffer watches every publish window
(``enable_watch``) and refuses outliers with ``outlier_rejected`` under
quarantine.

Not ported, raising NotImplementedError when its knob is set (ROADMAP.md,
Queue 1): the server mesh (``server_mesh``).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Optional

import torch

from ...core import telemetry as tel
from ...core.aggregation.async_buffer import buffer_from_args
from ...core.aggregation.bucketed import get_engine
from ...core.alg_frame.context import Context
from ...core.engine import knob_set, refuse_knobs, sample_from_pool, sample_silos
from ...core.privacy import WindowCoordinator, clip_to_reference, privacy_from_args
from ...core.telemetry import modelwatch
from ...core.telemetry.fleet import FleetTelemetry
from ...utils.pytree import tree_to_device

log = logging.getLogger(__name__)

_KNOBS = (("server_mesh", knob_set),)


def _float_tensor_leaves_only(tree) -> bool:
    """True iff ``tree`` is a state dict whose every leaf is a floating
    tensor: the only payloads ingested eagerly."""
    if not isinstance(tree, dict) or not tree:
        return False
    return all(isinstance(v, torch.Tensor) and v.is_floating_point() for v in tree.values())


class FedMLAggregator:
    def __init__(
        self,
        train_global,
        test_global,
        all_train_data_num,
        train_data_local_dict,
        test_data_local_dict,
        train_data_local_num_dict,
        client_num: int,
        device,
        args: Any,
        server_aggregator,
    ):
        refuse_knobs(args, _KNOBS, "the server mesh is")
        if os.environ.get("FEDML_SERVER_MESH", "").strip():
            raise NotImplementedError(
                "FEDML_SERVER_MESH: the server mesh is not ported to fedml_tpu_torch yet "
                "(see ROADMAP.md, Queue 1)")
        self.aggregator = server_aggregator
        self.args = args
        self.train_global = train_global
        self.test_global = test_global
        self.all_train_data_num = all_train_data_num
        self.train_data_local_dict = train_data_local_dict
        self.test_data_local_dict = test_data_local_dict
        self.train_data_local_num_dict = train_data_local_num_dict
        self.client_num = client_num
        self.device = torch.device(device)
        self.model_dict: Dict[int, Any] = {}
        self.sample_num_dict: Dict[int, float] = {}
        self.flag_client_model_uploaded_dict = {i: False for i in range(client_num)}
        Context().add(Context.KEY_TEST_DATA, test_global)
        # fleet view: per-rank telemetry deltas shipped on model upload
        self.fleet = FleetTelemetry()
        # async (non-barrier) rounds: arrivals fold into this buffer instead
        # of parking in model_dict until a round completes
        self.async_buffer = None
        if getattr(args, "async_rounds", False):
            self.async_buffer = buffer_from_args(args, health=self.fleet.health,
                                                 engine=get_engine())
        # privacy: masked windows attach to the async buffer as its privacy
        # session; DP noise rides the publish (async) or the round's mean
        # (sync). The server manager drives the window protocol.
        self.privacy_cfg = privacy_from_args(args)
        self.dp_fold = self.privacy_cfg.build_dp()
        self.secagg_coordinator = None
        if self.privacy_cfg.secagg:
            if self.async_buffer is None:
                raise ValueError(
                    "privacy=secagg masks per async publish window: set "
                    "args.async_rounds (the synchronous fronts' round-barrier SecAgg is "
                    "secure_aggregation)")
            n = int(getattr(args, "client_num_per_round", client_num) or client_num)
            ratio = None
            if str(getattr(args, "comm_compressor", "") or "") in ("topk", "eftopk"):
                # compose with the sparse uplink: the window's shared rand-k
                # support carries the configured ratio into the masked domain
                ratio = float(getattr(args, "comm_compressor_ratio", 0.05))
            self.secagg_coordinator = WindowCoordinator(
                self.async_buffer, self.get_global_model_params(),
                spec=self.privacy_cfg.quant_spec(n, n),
                threshold=self.privacy_cfg.threshold,
                dp=self.dp_fold, support_ratio=ratio)
        elif self.dp_fold is not None and self.async_buffer is not None:
            self.dp_fold.attach(self.async_buffer)
        # modelwatch: fold-boundary delta stats feeding the fleet's ledger;
        # masked ring vectors (secagg) would only show one-time-pad noise
        self._modelwatch = modelwatch.enabled(args) and self.secagg_coordinator is None
        self._mw_prev_update = None  # the last published update direction
        self._mw_round = 0
        if self._modelwatch:
            modelwatch.set_active(self.fleet.ledger)
            if self.async_buffer is not None and not self.async_buffer.enable_watch(
                    self.get_global_model_params(), ledger=self.fleet.ledger,
                    quarantine=modelwatch.quarantine_enabled(args)):
                log.warning("modelwatch: the async buffer cannot watch this model "
                            "(object leaves); its publishes run without statistics")

    def get_global_model_params(self):
        return self.aggregator.get_model_params()

    def set_global_model_params(self, model_parameters) -> None:
        self.aggregator.set_model_params(model_parameters)

    def _ingest(self, index: int, model_params):
        """A float state dict in the global's key order, on the server's
        device; any other payload as it came."""
        if _float_tensor_leaves_only(model_params):
            # the fold flattens each state dict in its own key order: put an
            # arrival from the wire (flax orders keys by name) in the
            # global's order
            ref = self.get_global_model_params()
            if list(model_params) != list(ref):
                if sorted(model_params) != sorted(ref):
                    raise ValueError(
                        f"client {index}'s upload has other parameters than the global model: "
                        f"{sorted(set(model_params) ^ set(ref))[:4]}")
                model_params = {k: model_params[k] for k in ref}
            # ONE host-to-device copy per dtype group, not one per leaf, so
            # the fold reads device-resident state dicts
            model_params = tree_to_device(model_params, self.device)
        return model_params

    def add_local_trained_result(self, index: int, model_params, sample_num) -> None:
        log.info("add_model. index = %d", index)
        self.model_dict[index] = self._ingest(index, model_params)
        self.sample_num_dict[index] = sample_num
        self.flag_client_model_uploaded_dict[index] = True

    # --- async (non-barrier) rounds ---------------------------------------
    def submit_async_result(self, index: int, model_params, sample_num,
                            client_version: Optional[int]) -> str:
        """Fold one arrival straight into the async buffer (no round
        barrier), after the same ingest as the synchronous path. Returns the
        staleness verdict."""
        model_params = self._ingest(index, model_params)
        if self.dp_fold is not None and self.secagg_coordinator is None:
            # DP sensitivity is a server-enforced bound, not a client
            # promise: re-clip this arrival's delta against the current
            # global before it folds (the input itself when the client
            # already clipped)
            model_params = clip_to_reference(
                model_params, self.get_global_model_params(), self.dp_fold.l2_clip)
        return self.async_buffer.submit(
            int(index), model_params, float(sample_num), client_version)

    def publish_async(self):
        """Publish a new global model from the buffered merges (None when
        nothing merged since the last publish) and install it. The async
        path is plain staleness-scaled sample-weighted averaging: the
        aggregation hooks, which need a whole round's client list, do not
        run here."""
        published = self.async_buffer.publish()
        if published is not None:
            self.set_global_model_params(published)
        return published

    def reset_round_flags(self) -> None:
        """Clear the upload flags after a quorum-driven (partial or
        keep-first-k) round completion: ``check_whether_all_receive`` only
        clears them when every flag is set, which such a round never
        reaches."""
        for i in list(self.flag_client_model_uploaded_dict):
            self.flag_client_model_uploaded_dict[i] = False

    def check_whether_all_receive(self) -> bool:
        if all(self.flag_client_model_uploaded_dict.get(i, False) for i in range(self.client_num)):
            for i in range(self.client_num):
                self.flag_client_model_uploaded_dict[i] = False
            return True
        return False

    def _modelwatch_session(self) -> Optional[modelwatch.WatchSession]:
        """A watch session against the current global params (the model this
        round's deltas trained from), or None when modelwatch is off or the
        model has object leaves (FHE ciphertexts), as in JAX."""
        if not self._modelwatch:
            return None
        ref = self.get_global_model_params()
        if modelwatch.has_object_leaves(ref):
            return None
        return modelwatch.WatchSession(ref, prev_update=self._mw_prev_update)

    def aggregate(self):
        start = time.perf_counter()
        with tel.span("server.aggregate", k=len(self.model_dict)):
            Context().add("client_indexes_of_round", sorted(self.model_dict))
            ranks = [i + 1 for i in sorted(self.model_dict)]  # sender ranks
            model_list = [(self.sample_num_dict[i], self.model_dict[i]) for i in sorted(self.model_dict)]
            model_list = self.aggregator.on_before_aggregation(model_list)
            watch = self._modelwatch_session() if model_list else None
            if watch is not None:
                if len(ranks) != len(model_list):  # a hook reshaped the cohort
                    ranks = list(range(len(model_list)))
                model_list = modelwatch.screen_cohort(
                    watch, model_list, ranks, ledger=self.fleet.ledger,
                    quarantine=modelwatch.quarantine_enabled(self.args))
            if self.dp_fold is not None:
                # enforce the sensitivity bound sigma is calibrated against:
                # clip each arrival's delta against the model this round
                # trained from, whether or not the client already did
                ref = self.get_global_model_params()
                model_list = [(n, clip_to_reference(m, ref, self.dp_fold.l2_clip))
                              for n, m in model_list]
            Context().add(Context.KEY_CLIENT_MODEL_LIST, model_list)
            averaged = self.aggregator.aggregate(model_list)
            averaged = self.aggregator.on_after_aggregation(averaged)
            if self.dp_fold is not None:
                # central DP on the synchronous round: noise the round's mean
                # with sigma calibrated to the cohort's size, and account it
                averaged = self.dp_fold.noise_tree(averaged, len(model_list))
            self.set_global_model_params(averaged)
            self.aggregator.assess_contribution()
            self.model_dict.clear()
            if watch is not None:
                try:
                    stats = watch.finish(averaged)
                    self._mw_prev_update = stats.update_tree
                    self.fleet.ledger.observe_round(self._mw_round, stats)
                except Exception:  # noqa: BLE001 - logged below; stats must not fail the round
                    log.warning("modelwatch: round %d's stats failed", self._mw_round,
                                exc_info=True)
                self._mw_round += 1
        dt = time.perf_counter() - start
        tel.histogram("server.aggregate_seconds").observe(dt)
        log.info("aggregate time cost: %.3fs", dt)
        return averaged

    # --- fleet telemetry --------------------------------------------------
    def merge_client_telemetry(self, rank: int, delta: Any) -> bool:
        """Fold one client's shipped telemetry delta into the fleet view."""
        return self.fleet.merge_client_delta(rank, delta)

    def fleet_summary(self) -> Dict[str, Any]:
        return self.fleet.summary()

    def export_fleet_trace(self, path: str) -> str:
        """One Perfetto JSON: the server's lane and one lane per client rank."""
        return self.fleet.export_fleet_trace(path, server=tel.get_telemetry())

    def data_silo_selection(self, round_idx: int, client_num_in_total: int, client_num_per_round: int) -> List[int]:
        """reference fedml_aggregator.py data_silo_selection — sample which
        data silos the online clients should train on this round."""
        return sample_silos(round_idx, client_num_in_total, client_num_per_round)

    def client_selection(self, round_idx: int, client_id_list_in_total: List[int], client_num_per_round: int) -> List[int]:
        return sample_from_pool(round_idx, client_id_list_in_total, client_num_per_round)

    def test_on_server_for_all_clients(self, round_idx: int) -> Optional[Dict[str, float]]:
        freq = int(getattr(self.args, "frequency_of_the_test", 5))
        comm_round = int(getattr(self.args, "comm_round", 10))
        if round_idx % max(freq, 1) != 0 and round_idx != comm_round - 1:
            return None
        metrics = self.aggregator.test(self.test_global, self.device, self.args)
        metrics["round"] = round_idx
        log.info("server test round %d: %s", round_idx, metrics)
        return metrics
