"""Cross-silo server manager (the WAN state machine, server side): the
counterpart of ``fedml_tpu/cross_silo/server/fedml_server_manager.py``.

Reference: ``cross_silo/server/fedml_server_manager.py:15`` — gate on all
clients ONLINE (:124-144), send_init_msg (:48-67), per-model receive ->
aggregate -> sync (steps 3-8 of SURVEY §3.2).

Spans: ``server.round`` (one per round, the trace root whose context rides
every broadcast), ``server.broadcast`` (the engine's ``RemoteCommStrategy``),
``server.receive_model`` (one per kept arrival), ``server.aggregate`` (the
aggregator) and ``server.eval``. The server's wait for its cohort is
``server.round`` less the others. As in the JAX package, round 0's INIT
messages go out inside ``server.round`` but outside ``server.broadcast``.

Quorum rounds (JAX ``:569-750``; ``quorum_frac``, ``round_deadline_s``,
``adaptive_deadline``, ``overprovision_frac``): each round's uploads are
judged by a ``RoundQuorum`` (late and surplus deltas are discarded and
counted) and a ``threading.Timer`` closes the round at its deadline with
what arrived when the quorum is met, marking the missing ranks failed in
the fleet's health, else extends it. With stragglers flagged by health the
cohort is over-provisioned from ``client_num_connected`` clients and the
first ``client_num_per_round`` deltas are kept. Every round-advancing
decision holds ``_round_lock``.

Durable round state (``resilience_dir``, ``resume``, JAX ``:104-141``,
``:952-965``): each round boundary is checkpointed through the engine's
``RoundCheckpointer``; a resumed server restores the model, the numpy RNG,
the health baselines and, in async mode, the half-full buffer, and stamps
its round index on the init and sync messages so the clients' seeds follow.

Async rounds (``async_rounds``, JAX ``:753-866``): every arrival folds into
the aggregator's FedBuff buffer at once (``server.async_receive``), a model
publishes every ``async_publish_k`` merges, and each upload is answered to
its sender alone with the newest global and its ``MODEL_VERSION``;
``round_idx`` counts publishes and the run finishes after ``comm_round`` of
them. ``async_checkpoint_every_merges`` snapshots the buffer mid-window. A
compressed upload (``comm_compressor`` on the clients) is decompressed on
arrival (``server.decompress``) on either path. ``fleet_trace`` writes the
fleet's Perfetto JSON at the end of the run. The clients' telemetry deltas
are merged into the fleet view only under a knob that reads it (quorum,
async, ``resilience_dir``, ``fleet_trace``).

Windowed SecAgg (``privacy: secagg``, JAX ``:321-514``, ``:546``,
``:768-780``, ``:865``): the first masking window opens over the cohort
before any upload, and a fresh one after every publish. A window runs over
the message plane: ANNOUNCE (id, nonce, grid spec, threshold, the support
ratio) to every member, the public-key DIRECTORY once every key is in,
then a SHARE_RELAY of each dealt Shamir share. Masked uploads fold through
the coordinator, and the window publishes when its cohort is complete
(not at the buffer's merge count). A ``threading.Timer`` deadline
(``secagg_window_deadline_s``) fires with members missing: below the
reveal quorum it extends, else it sends REVEAL_REQUESTs to the survivors
and re-arms; a window past ``secagg_window_max_extensions`` firings is
aborted (its epoch discarded) and reopened over the live members. The
reveals' handler closes the window partial once every dropped rank has
its quorum of shares. As for the round deadline, the callback takes the
round lock and the server's device and compares window ids, and the timer
is cancelled when the run ends.

Telemetry (JAX ``:140-240``): ``run`` runs under the flight recorder
(``flight_recorded(role="cross_silo_server")``: an exception in any
handler writes one crash dump with the open round span), activates the
SLO engine (``front="cross_silo"``, ticked once a round after the health
round closes, and every ``slo_tick_s`` when set) with the health, fleet
sketch and DP accountant collectors, and with ``statusz_port`` (0: an
ephemeral port, written to ``statusz_port_file``) serves `/statusz` (the
``round``, ``health``, ``async`` and ``privacy`` sections beside the
always-on ones, devperf's and modelwatch's among them) and `/metrics`
(with the contribution ledger's ``fedml_client_{delta_norm,contribution,
outlier_score}`` gauges). Each round's health report carries the ledger's
view before the SLO tick, and ``run`` clears the active ledger as it ends. Under
``statusz_port``, ``slo_spec`` or ``slo_tick_s`` the fleet view is read, so
the clients' telemetry deltas are merged.

The link layer (JAX ``:76-92``, ``:275-320``, ``:622-625``, ``:714-725``,
``:1011-1020``): every message is booked into netlink by the comm manager.
``link_probe_interval_s`` starts a ``LinkProber`` once the fleet is online
(every connected client, a zero and a ``link_probe_payload_bytes`` probe a
tick; the clients echo them, the echo handler feeds the RTT, the
``link_probe`` statusz section shows it; a failed tick fails the run when
the prober stops). ``link_wan_health`` observes each client's round as
broadcast to arrival on the server's monotonic clock, booked after the
delta merge, so a slow link flags in health as a slow trainer does.
``quorum_link_cost`` stretches each rank's adaptive-deadline budget by its
predicted upload seconds (``deadline_budgets`` keeps the last round's), and
``async_link_admission`` stretches the staleness admission cut by the
publish windows a silo's predicted upload spans; both predict the last
broadcast's byte count on the (client, server) pair. The buffer judges an
arrival by silo index (rank - 1); the port's predictor maps it to the
silo's rank, where JAX's reads the previous rank's link (ROADMAP.md,
Queue 3).

Not ported: the split-learning chaos knobs (``chaos_split_*``) raise
NotImplementedError (ROADMAP.md, Queue 1). The JAX package also logs the
SecAgg dropouts and aborts to mlops; that is not ported.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ...core import telemetry as tel
from ...core.distributed import link_probe
from ...core.distributed.communication.message import Message
from ...core.distributed.fedml_comm_manager import FedMLCommManager
from ...core.engine import (RemoteCommStrategy, RoundCheckpointer, decompress_arrival,
                            flight_recorded, knob_set, refuse_chaos_knobs)
from ...core.privacy import is_masked_payload, submit_masked_payload
from ...core.resilience import (QuorumPolicy, RoundQuorum, RoundStateStore, note,
                                overprovisioned_cohort_size)
from ...core.resilience import quorum as quorum_mod
from ...core.resilience.round_state import restore_numpy_rng
from ...core.telemetry import modelwatch, netlink, slo, statusz, trace_context
from ..message_define import MyMessage

log = logging.getLogger(__name__)


class FedMLServerManager(FedMLCommManager):
    def __init__(self, args: Any, aggregator, comm=None, client_rank=0, client_num=0, backend="INMEMORY"):
        refuse_chaos_knobs(args)
        super().__init__(args, comm, client_rank, client_num + 1, backend)
        self.aggregator = aggregator
        self.round_num = int(getattr(args, "comm_round", 10))
        self.args.round_idx = 0
        self.client_online_status: Dict[int, bool] = {}
        self.client_id_list_in_this_round = None
        self.data_silo_index_list = None
        self.is_initialized = False
        self.final_metrics: Optional[Dict[str, float]] = None
        # distributed tracing: one trace id per run; each round is a
        # server.round span whose seq is the parent of everything the round's
        # broadcasts reach (clients restore it from the message header)
        self.trace_id = trace_context.new_trace_id()
        self._round_span = None
        self._round_span_idx: Optional[int] = None
        # async (non-barrier) rounds: round_idx counts PUBLISHES, every upload
        # gets an immediate model reply, and each client's silo assignment is
        # remembered for those replies
        self._async_mode = bool(getattr(args, "async_rounds", False))
        self._silo_of: Dict[int, int] = {}
        # broadcast half of the engine's remote-comm strategy: arrivals come
        # back through the message handlers, so only the server.broadcast
        # side runs here
        self._strategy = RemoteCommStrategy(self.send_message_sync_model_to_client)
        # --- resilience: quorum rounds + durable round state ---------------
        self._quorum_policy = QuorumPolicy.from_args(args)
        self._round_quorum: Optional[RoundQuorum] = None
        self._keep_k = int(getattr(args, "client_num_per_round", self.size - 1))
        # deltas arrive on the receive loop while the deadline timer fires on
        # its own thread: every round-advancing decision holds this lock
        self._round_lock = threading.RLock()
        self._deadline_timer: Optional[threading.Timer] = None
        # windowed SecAgg: the window deadline's timer and its firings
        self._secagg_deadline_timer: Optional[threading.Timer] = None
        self._secagg_deadline_attempts = 0
        self._round_store: Optional[RoundStateStore] = None
        self._checkpointer: Optional[RoundCheckpointer] = None
        # --- link telemetry ------------------------------------------------
        # active probing is opt-in (args.link_probe_interval_s > 0); passive
        # per-pair accounting in FedMLCommManager is always on
        self._link_prober: Optional[link_probe.LinkProber] = None
        # WAN-aware health (args.link_wan_health): each client's round as
        # broadcast->arrival on the server's monotonic clock
        self._link_wan_health = bool(getattr(args, "link_wan_health", False))
        self._bcast_sent_mono: Dict[int, float] = {}
        self._last_bcast_nbytes = 0
        # quorum_link_cost: each rank's budget behind the last armed deadline
        self.deadline_budgets: Dict[int, float] = {}
        if self._async_mode and bool(getattr(args, "async_link_admission", False)):
            # the staleness admission cut stretches for ranks whose predicted
            # upload time spans publish windows
            buf = aggregator.async_buffer
            predict = netlink.make_upload_predictor(lambda _r: self._last_bcast_nbytes)
            # the buffer judges an arrival by its silo index (rank - 1), as
            # the aggregator hands it over; the link is the silo's rank's
            # (JAX predicts the previous rank's link: ROADMAP.md, Queue 3)
            buf.policy.set_link_predictor(
                lambda index: predict(int(index) + 1),
                lambda: buf.publish_interval_ewma_s,
            )
        rdir = getattr(args, "resilience_dir", None)
        # the fleet view has readers only under these knobs: the quorum
        # (failures, adaptive deadline, over-provisioning), the async
        # buffer's straggler grace, the round state's health, the fleet
        # trace, /statusz's health section, the SLO rows an operator
        # configured and the WAN-aware health. Without them the clients'
        # deltas are not merged and the round runs as it does without
        # resilience.
        self._fleet_read = bool(self._quorum_policy.enabled or self._async_mode or rdir
                                or self._link_wan_health
                                or getattr(args, "fleet_trace", None)
                                or getattr(args, "statusz_port", None) is not None
                                or knob_set(getattr(args, "slo_spec", None))
                                or knob_set(getattr(args, "slo_tick_s", None)))
        self._slo: Optional[slo.SLOEngine] = None
        self._statusz_server: Optional[statusz.StatuszServer] = None
        if rdir:
            self._round_store = RoundStateStore(str(rdir))
            self._checkpointer = RoundCheckpointer(self._round_store, args,
                                                   async_mode=self._async_mode)
            if getattr(args, "resume", False):
                self._try_resume()

    def _try_resume(self) -> None:
        """Restart from the last complete round: restore the global model,
        the cohort's health baselines and the numpy RNG, and set
        ``round_idx`` to the first round that never finished. In async mode
        the checkpoint also carries the buffer (accumulator, un-folded
        pending arrivals, staleness clock), so a SIGKILL mid-window resumes
        with the partial buffer intact."""
        model_template = self.aggregator.get_global_model_params()
        template: Dict[str, Any] = {"model": model_template}
        buf = getattr(self.aggregator, "async_buffer", None)
        buf_meta = None
        if self._async_mode and buf is not None:
            # the pending count varies per snapshot: read the sidecar first so
            # the template matches the saved structure
            step = self._round_store.latest_complete_round()
            meta = self._round_store.read_meta(step) if step is not None else None
            buf_meta = (meta or {}).get("async_buffer")
            if buf_meta:
                btmpl = buf.state_template(model_template, buf_meta)
                if btmpl:
                    template["async_buffer"] = btmpl
        rs = self._round_store.resume(template=template)
        if rs is None:
            return
        self.aggregator.set_global_model_params(rs.state["model"])
        if self._async_mode and buf is not None and buf_meta:
            buf.restore(rs.state.get("async_buffer", {}), buf_meta, template=rs.state["model"])
            self.args.round_idx = buf.version
        else:
            self.args.round_idx = rs.round_idx + 1
        restore_numpy_rng(rs.meta.get("numpy_rng"))
        self.aggregator.fleet.health.restore_state(rs.meta.get("health"))
        log.info("server resumed: round %d complete, restarting at round %d",
                 rs.round_idx, self.args.round_idx)

    def run(self) -> None:
        from ...core.telemetry import sketches as fleet_sketches

        # the whole receive loop runs under the flight recorder: an exception
        # in any handler produces one crash dump with the open round span
        with flight_recorded(role="cross_silo_server"):
            self._slo = slo.activate(self.args, front="cross_silo")
            fleet = self.aggregator.fleet
            # the fleet's merged sketch view feeds /metrics, /statusz, crash
            # dumps and the tsdb series the fleet SLO rows watch
            fleet_sketches.set_active_provider(fleet.sketch_view)
            if self._slo is not None:
                self._slo.store.add_collector(self._slo_health_collector)
                self._slo.store.add_collector(fleet_sketches.tsdb_collector)
                accountant = self._dp_accountant
                if accountant is not None:
                    # privacy.dp_epsilon_spent / dp_budget_frac: the
                    # dp_budget_exhaustion row fires before the budget is
                    # crossed
                    self._slo.store.add_collector(accountant.tsdb_collector)
            self._start_statusz_if_configured()
            try:
                super().run()
            finally:
                self._stop_link_prober()
                self._stop_statusz()
                slo.deactivate(self._slo)
                self._slo = None
                modelwatch.clear_active()
                fleet_sketches.set_active_provider(None)

    @property
    def _dp_accountant(self):
        dp = getattr(self.aggregator, "dp_fold", None)
        return dp.accountant if dp is not None else None

    # --- link probing ------------------------------------------------------
    def _start_link_prober(self) -> None:
        """Start the active prober once the fleet is online (configured via
        ``args.link_probe_interval_s``; default off). Probes every connected
        client, not just the round's cohort: a link estimate is most useful
        for the clients about to be re-admitted."""
        cfg = link_probe.probe_config(self.args)
        if cfg is None or self._link_prober is not None:
            return
        self._link_prober = link_probe.LinkProber(
            local_rank=self.rank,
            send_probe=self._send_link_probe,
            peers=lambda: range(1, self.size),
            registry=netlink.get_registry(),
            backend=self.backend.lower(),
            **cfg,
        )
        self._link_prober.start()
        statusz.register_section("link_probe", self._link_prober.statusz)

    def _stop_link_prober(self) -> None:
        """Stop the prober; raises the error that ended its thread, if any."""
        prober, self._link_prober = self._link_prober, None
        if prober is None:
            return
        statusz.unregister_section("link_probe")
        prober.stop()

    def _send_link_probe(self, peer: int, seq: int, t_send_ns: int, nbytes: int) -> None:
        message = Message(MyMessage.MSG_TYPE_LINK_PROBE, self.get_sender_id(), peer)
        message.add_params(MyMessage.MSG_ARG_KEY_PROBE_SEQ, int(seq))
        message.add_params(MyMessage.MSG_ARG_KEY_PROBE_T_SEND_NS, int(t_send_ns))
        message.add_params(MyMessage.MSG_ARG_KEY_PROBE_NBYTES, int(nbytes))
        if nbytes > 0:
            message.add_params(MyMessage.MSG_ARG_KEY_PROBE_PAD, np.zeros(int(nbytes), dtype=np.uint8))
        self.send_message(message)

    def handle_message_link_probe_echo(self, msg_params: Message) -> None:
        if self._link_prober is not None:
            self._link_prober.observe_echo(
                msg_params.get_sender_id(),
                msg_params.get(MyMessage.MSG_ARG_KEY_PROBE_SEQ),
                msg_params.get(MyMessage.MSG_ARG_KEY_PROBE_T_SEND_NS),
            )

    # --- statusz and the SLO engine ------------------------------------------
    def _start_statusz_if_configured(self) -> None:
        """Serve `/statusz` + `/metrics` when ``args.statusz_port`` is set
        (0: an ephemeral port; the bound port is written to
        ``args.statusz_port_file`` if given)."""
        port = getattr(self.args, "statusz_port", None)
        if port is None:
            return
        fleet = self.aggregator.fleet
        buf = getattr(self.aggregator, "async_buffer", None)
        statusz.register_section("round", self._statusz_round_section)
        statusz.register_section("health", fleet.health.statusz)
        if buf is not None:
            statusz.register_section("async", buf.statusz)
        if self.aggregator.privacy_cfg.enabled:
            statusz.register_section("privacy", self._statusz_privacy_section)

        def gauges():
            out = list(fleet.health.prom_gauges())
            if buf is not None:
                out.extend(buf.prom_gauges())
            co = self._secagg
            if co is not None:
                out.extend(co.prom_gauges())
            dp = getattr(self.aggregator, "dp_fold", None)
            if dp is not None:
                out.extend(dp.prom_gauges())
            # the contribution ledger (modelwatch), once one was built
            led = fleet._ledger
            if led is not None:
                out.extend(led.prom_gauges())
            return out

        port_file = getattr(self.args, "statusz_port_file", None)
        self._statusz_server = statusz.StatuszServer(
            port=int(port), service="cross_silo_server", gauges_fn=gauges,
            port_file=str(port_file) if port_file else None)
        bound = self._statusz_server.start()
        log.info("statusz serving on http://127.0.0.1:%d/statusz", bound)

    def _stop_statusz(self) -> None:
        if self._statusz_server is None:
            return
        for name in ("round", "health", "async", "privacy"):
            statusz.unregister_section(name)
        self._statusz_server.stop()
        self._statusz_server = None

    def _statusz_privacy_section(self) -> dict:
        doc: Dict[str, Any] = {"mode": self.aggregator.privacy_cfg.mode}
        co = self._secagg
        if co is not None:
            doc["secagg"] = co.statusz()
        dp = getattr(self.aggregator, "dp_fold", None)
        if dp is not None:
            doc["dp"] = dp.statusz()
        return doc

    def _statusz_round_section(self) -> dict:
        doc = {
            "round_idx": int(self.args.round_idx),
            "round_num": self.round_num,
            "initialized": self.is_initialized,
            "clients_online": len(self.client_online_status),
            "cohort": list(self.client_id_list_in_this_round or []),
        }
        # no _round_lock: the receive loop holds it across aggregation, and a
        # status page that blocks on a live round is useless mid-round
        q = self._round_quorum
        if q is not None:
            doc["quorum"] = q.statusz()
        return doc

    def _slo_tick(self) -> None:
        """The per-round SLO evaluator tick (a no-op with SLOs disabled)."""
        if self._slo is not None:
            self._slo.tick()

    def _slo_health_collector(self, store) -> None:
        """Feed the live straggler ratio (flagged / cohort size from the
        fleet's latest health report) into the tsdb each tick, for the
        ``straggler_ratio`` SLO."""
        report = self.aggregator.fleet.health.report()
        if not report:
            return
        n = int((report.get("cohort") or {}).get("n") or 0)
        if n > 0:
            store.record_gauge("health.straggler_ratio",
                               len(report.get("stragglers") or ()) / n)

    def _begin_round_trace(self) -> None:
        self._end_round_trace()
        sp = tel.get_telemetry().span("server.round", round=int(self.args.round_idx))
        sp.__enter__()
        self._round_span = sp
        self._round_span_idx = int(self.args.round_idx)
        trace_context.set_current(
            trace_context.TraceContext(self.trace_id, getattr(sp, "seq", None), int(self.args.round_idx))
        )

    def _end_round_trace(self) -> None:
        if self._round_span is None:
            return
        # the round span is the trace root: record it parentless, not
        # pointing at its own seq
        trace_context.set_current(
            trace_context.TraceContext(self.trace_id, None, self._round_span_idx)
        )
        self._round_span.__exit__(None, None, None)
        self._round_span = None
        trace_context.set_current(None)

    # --- round bootstrap --------------------------------------------------
    def send_init_msg(self) -> None:
        self._begin_round_trace()
        global_model_params = self.aggregator.get_global_model_params()
        for idx, client_id in enumerate(self.client_id_list_in_this_round):
            self.send_message_init_config(
                client_id, global_model_params, self.data_silo_index_list[idx]
            )
        self._begin_quorum_round()
        # first masking window: over the initial cohort, before any upload
        self._secagg_open_window()

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(MyMessage.MSG_TYPE_CONNECTION_IS_READY, self.handle_message_connection_ready)
        self.register_message_receive_handler(MyMessage.MSG_TYPE_C2S_CLIENT_STATUS, self.handle_message_client_status_update)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self.handle_message_receive_model_from_client
        )
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_LINK_PROBE_ECHO, self.handle_message_link_probe_echo)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_SECAGG_PUBKEY, self.handle_message_secagg_pubkey)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_SECAGG_SHARES, self.handle_message_secagg_shares)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_SECAGG_REVEAL, self.handle_message_secagg_reveal)

    # --- cohort selection -------------------------------------------------
    def _select_cohort(self) -> None:
        """Pick this round's cohort of client ranks and their data silos.
        With over-provisioning on and stragglers flagged last round, samples
        ``ceil(k·(1+f))`` clients; the quorum keeps the first k deltas."""
        k = int(getattr(self.args, "client_num_per_round", self.size - 1))
        n_sample = k
        if self._quorum_policy.overprovision_frac > 0:
            report = self.aggregator.fleet.health.report()
            stragglers = bool(report and report.stragglers)
            n_sample = overprovisioned_cohort_size(
                k, self._quorum_policy.overprovision_frac, stragglers, self.size - 1
            )
            if n_sample > k:
                log.info("round %d: over-provisioning cohort %d -> %d (stragglers flagged)",
                         self.args.round_idx, k, n_sample)
                note(overprovisioned={"round": int(self.args.round_idx), "k": k, "sampled": n_sample})
        self.client_id_list_in_this_round = self.aggregator.client_selection(
            self.args.round_idx, list(range(1, self.size)), n_sample
        )
        self.data_silo_index_list = self.aggregator.data_silo_selection(
            self.args.round_idx,
            int(getattr(self.args, "client_num_in_total", self.size - 1)),
            len(self.client_id_list_in_this_round),
        )
        self._keep_k = min(k, len(self.client_id_list_in_this_round))
        # async replies go to one sender at a time, long after the cohort
        # list was built: remember each client's silo
        self._silo_of = {int(cid): int(self.data_silo_index_list[i])
                         for i, cid in enumerate(self.client_id_list_in_this_round)}
        if self._fleet_read:
            # a late delta from a reshuffled-out rank is then skipped, not raised on
            self.aggregator.fleet.set_expected_ranks(self.client_id_list_in_this_round)

    # --- quorum round lifecycle -------------------------------------------
    def _begin_quorum_round(self) -> None:
        if self._async_mode or not self._quorum_policy.enabled:
            return  # async: no barrier, the staleness policy governs instead
        with self._round_lock:
            self._cancel_deadline_timer()
            self._round_quorum = RoundQuorum(
                int(self.args.round_idx),
                self.client_id_list_in_this_round,
                self._keep_k,
                self._quorum_policy,
            )
            note(last_quorum=self._round_quorum.statusz())
            self._arm_deadline_timer()

    def _arm_deadline_timer(self) -> None:
        health = self.aggregator.fleet.health
        link_predict = None
        if self._quorum_policy.use_link_cost:
            # stretch each rank's EWMA by its predicted upload time; the last
            # broadcast's size is the best estimate of the symmetric upload
            link_predict = netlink.make_upload_predictor(lambda _r: self._last_bcast_nbytes)
            self.deadline_budgets = self._quorum_policy.rank_budgets(health, link_predict)
        deadline_s = self._quorum_policy.deadline_for_round(health, link_predict=link_predict)
        if deadline_s is None:
            return
        t = threading.Timer(deadline_s, self._on_round_deadline, args=(int(self.args.round_idx),))
        t.daemon = True
        t.start()
        self._deadline_timer = t

    def _cancel_deadline_timer(self) -> None:
        if self._deadline_timer is not None:
            self._deadline_timer.cancel()
            self._deadline_timer = None

    def _on_round_deadline(self, round_idx: int) -> None:
        """Timer thread: the round's deadline fired. Aggregate partially if
        the quorum is there, on the server's device; otherwise extend by one
        more deadline period."""
        device = getattr(self.aggregator, "device", None)
        on_card = torch.cuda.device(device) if getattr(device, "type", None) == "cuda" \
            else contextlib.nullcontext()
        with on_card, self._round_lock:
            q = self._round_quorum
            if q is None or q.round_idx != round_idx or int(self.args.round_idx) != round_idx:
                return  # the round already advanced
            if not q.deadline_quorum_met():
                log.warning(
                    "round %d deadline: quorum not met (%d/%d arrived, need %d), extending",
                    round_idx, len(q.arrived()), q.keep_k,
                    self._quorum_policy.min_quorum(q.keep_k),
                )
                self._arm_deadline_timer()
                return
            missing = q.close_partial()
            for r in missing:
                self.aggregator.fleet.health.observe_failure(r)
            note(last_quorum=q.statusz())
            log.warning("round %d: partial aggregation with %s (missing %s)",
                        round_idx, q.arrived(), missing)
            self._complete_round()

    # --- handlers ---------------------------------------------------------
    def handle_message_connection_ready(self, msg_params: Message) -> None:
        if self.is_initialized:
            return
        self._select_cohort()

    def handle_message_client_status_update(self, msg_params: Message) -> None:
        status = msg_params.get(MyMessage.MSG_ARG_KEY_CLIENT_STATUS)
        sender = msg_params.get_sender_id()
        if status == MyMessage.MSG_CLIENT_STATUS_ONLINE:
            self.client_online_status[sender] = True
            log.info("client %d online (%d/%d)", sender, len(self.client_online_status), self.size - 1)
        all_online = all(self.client_online_status.get(cid, False) for cid in range(1, self.size))
        if all_online and not self.is_initialized:
            self.is_initialized = True
            self._start_link_prober()
            if int(self.args.round_idx) >= self.round_num:
                # resumed from a store whose last complete round was the
                # final one: nothing left to train, release the fleet
                log.info("resume found all %d rounds complete; finishing", self.round_num)
                self.send_finish_to_all()
                self.finish()
                return
            self.send_init_msg()

    def handle_message_receive_model_from_client(self, msg_params: Message) -> None:
        sender_id = msg_params.get_sender_id()
        local_sample_number = msg_params.get(MyMessage.MSG_ARG_KEY_NUM_SAMPLES)
        delta_round = msg_params.get(MyMessage.MSG_ARG_KEY_ROUND_IDX)
        if self._fleet_read:
            header = trace_context.telemetry_header(msg_params)
            if header is not None and trace_context.DELTA_FIELD in header:
                self.aggregator.merge_client_telemetry(sender_id, header[trace_context.DELTA_FIELD])
        if self._link_wan_health:
            # WAN-aware round time: broadcast->arrival on this clock. Booked
            # after the delta merge so it supersedes the train-span
            # observation for this round: a throttled link then flags in
            # health exactly like a slow trainer would
            sent_mono = self._bcast_sent_mono.pop(int(sender_id), None)
            if sent_mono is not None:
                self.aggregator.fleet.health.observe_round(
                    int(sender_id), time.monotonic() - sent_mono,
                    None if delta_round is None else int(delta_round))
        if self._async_mode:
            model_params = decompress_arrival(msg_params.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS),
                                              sender_id)
            self._handle_async_upload(sender_id, model_params, local_sample_number, msg_params)
            return
        with self._round_lock:
            q = self._round_quorum
            if q is not None:
                verdict = q.on_delta(sender_id, None if delta_round is None else int(delta_round))
                if verdict != quorum_mod.ACCEPT:
                    # late, surplus or duplicate: the delta is dropped unread
                    # (never ingested), but the rank is alive
                    self.aggregator.fleet.health.heartbeat(sender_id)
                    note(last_quorum=q.statusz())
                    return
            model_params = decompress_arrival(msg_params.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS),
                                              sender_id)
            with tel.span("server.receive_model", round=int(self.args.round_idx), sender=int(sender_id)):
                self.aggregator.add_local_trained_result(sender_id - 1, model_params, local_sample_number)
            if q is not None:
                note(last_quorum=q.statusz())
                if not q.complete():
                    return
            elif not self.aggregator.check_whether_all_receive():
                return
            self._complete_round()

    def _complete_round(self) -> None:
        """Aggregate (every arrival, or the quorum's kept set), evaluate,
        persist the round state, and advance — or finish the run. The caller
        holds ``_round_lock`` (receive loop or deadline timer)."""
        self._cancel_deadline_timer()
        round_idx = int(self.args.round_idx)
        # FedMLAggregator.aggregate opens the server.aggregate span itself
        global_model_params = self.aggregator.aggregate()
        if self._round_quorum is not None:
            # a partial or keep-first-k round leaves upload flags set
            self.aggregator.reset_round_flags()
            self._round_quorum = None
        with tel.span("server.eval", round=round_idx):
            metrics = self.aggregator.test_on_server_for_all_clients(round_idx)
        if metrics is not None:
            self.final_metrics = metrics
        tel.counter("engine.rounds").add(1)
        fleet = self.aggregator.fleet
        if fleet.merges:
            # close the health round: the MAD straggler test over this
            # round's client.train durations
            report = fleet.health.end_round(round_idx)
            # the report rides with the contribution ledger's view, before
            # the SLO tick, so the round's alert state holds its rows
            if fleet._ledger is not None:
                fleet._ledger.annotate_report(report)
            if report.stragglers:
                log.warning("round %d stragglers: %s", round_idx, report.stragglers)
        # the evaluator ticks after end_round: a fresh straggler ratio
        self._slo_tick()
        self._save_round_state(round_idx, global_model_params,
                               final=(round_idx + 1 >= self.round_num))
        self.args.round_idx += 1
        if self.args.round_idx >= self.round_num:
            self.send_finish_to_all()
            self._end_round_trace()
            self._export_fleet_trace_if_configured()
            self.finish()
            return
        self._select_cohort()
        self._begin_round_trace()
        self._strategy.broadcast(
            int(self.args.round_idx), global_model_params,
            self.client_id_list_in_this_round, self.data_silo_index_list,
        )
        self._begin_quorum_round()

    # --- async (non-barrier) flow ------------------------------------------
    def _handle_async_upload(self, sender_id: int, model_params, local_sample_number,
                             msg_params: Message) -> None:
        """One async arrival: fold it at once, publish if the window filled
        (else snapshot the buffer on the mid-window cadence), and reply to
        THIS sender with the newest global model so it starts its next local
        round while the others still train."""
        client_version = msg_params.get(MyMessage.MSG_ARG_KEY_MODEL_VERSION)
        buf = self.aggregator.async_buffer
        co = self._secagg
        with self._round_lock:
            with tel.span("server.async_receive", sender=int(sender_id), version=buf.version):
                if co is not None:
                    # a masked ring payload folds through the window session
                    # (weight 1.0); the raw state-dict path never sees it
                    if not is_masked_payload(model_params):
                        log.warning("privacy=secagg: dropping unmasked upload from rank %d",
                                    int(sender_id))
                        return
                    submit_masked_payload(
                        co, model_params, None if client_version is None else int(client_version))
                else:
                    self.aggregator.submit_async_result(
                        sender_id - 1, model_params, local_sample_number,
                        None if client_version is None else int(client_version))
            self.aggregator.fleet.health.heartbeat(sender_id)
            note(last_async=buf.statusz())
            ckpt_every = int(getattr(self.args, "async_checkpoint_every_merges", 0) or 0)
            if co is not None:
                # a masked window publishes when its COHORT completes (every
                # member's masks must be in the sum before they can cancel),
                # not at the buffer's merge count
                window = co.window
                if window is not None and not window.closed and window.complete():
                    self._cancel_secagg_deadline()
                    self._complete_async_publish()
                    if self.args.round_idx >= self.round_num:
                        return  # finished: S2C_FINISH already sent
            elif buf.ready():
                self._complete_async_publish()
                if self.args.round_idx >= self.round_num:
                    return  # finished: S2C_FINISH already sent to everyone
            elif ckpt_every and buf.merges_total % ckpt_every == 0:
                # mid-window durability: snapshot the half-full buffer so a
                # SIGKILL here resumes with the partial merges intact
                self._save_round_state(int(self.args.round_idx),
                                       self.aggregator.get_global_model_params())
            self.send_message_sync_model_to_client(
                sender_id, self.aggregator.get_global_model_params(),
                self._silo_of.get(int(sender_id), sender_id - 1))

    def _complete_async_publish(self) -> None:
        """Publish one model generation and do its bookkeeping."""
        if self.aggregator.publish_async() is None:
            return
        self._after_async_publish()

    def _after_async_publish(self) -> None:
        """Evaluate the generation just published on the test cadence, close
        the health round, checkpoint, and finish the run after
        ``comm_round`` publishes. The new global is installed."""
        global_model_params = self.aggregator.get_global_model_params()
        buf = self.aggregator.async_buffer
        round_idx = buf.version - 1  # the generation just published
        self.args.round_idx = buf.version
        with tel.span("server.eval", round=round_idx):
            metrics = self.aggregator.test_on_server_for_all_clients(round_idx)
        if metrics is not None:
            self.final_metrics = metrics
        tel.counter("engine.rounds").add(1)
        fleet = self.aggregator.fleet
        if fleet.merges:
            report = fleet.health.end_round(round_idx)
            if fleet._ledger is not None:
                fleet._ledger.annotate_report(report)
        self._slo_tick()
        final = buf.version >= self.round_num
        self._save_round_state(round_idx, global_model_params, final=final)
        if final:
            self._cancel_secagg_deadline()
            self.send_finish_to_all()
            self._end_round_trace()
            self._export_fleet_trace_if_configured()
            self.finish()
            return
        self._begin_round_trace()
        # next masking cohort: one window per publish generation
        self._secagg_open_window()

    # --- windowed SecAgg driver (the server side of core/privacy) ----------
    @property
    def _secagg(self):
        return self.aggregator.secagg_coordinator

    def _secagg_open_window(self, cohort=None) -> None:
        """Open the next masking window over the current cohort (or the
        survivors of an aborted window) and ANNOUNCE it (id, nonce, grid
        spec, threshold) to every member. Key exchange runs over the
        message plane."""
        co = self._secagg
        if cohort is None:
            cohort = self.client_id_list_in_this_round
        if co is None or not cohort:
            return
        self._secagg_deadline_attempts = 0
        cohort = [int(c) for c in cohort]
        window, _ = co.open_window(cohort, run_key_exchange=False)
        spec_doc = dict(co.spec.as_dict())
        if co.support_ratio is not None:
            spec_doc["support_ratio"] = float(co.support_ratio)
        for cid in cohort:
            msg = Message(MyMessage.MSG_TYPE_S2C_SECAGG_ANNOUNCE, self.get_sender_id(), cid)
            msg.add_params(MyMessage.MSG_ARG_KEY_SECAGG_WINDOW_ID, window.window_id)
            msg.add_params(MyMessage.MSG_ARG_KEY_SECAGG_NONCE, window.nonce)
            msg.add_params(MyMessage.MSG_ARG_KEY_SECAGG_COHORT, cohort)
            msg.add_params(MyMessage.MSG_ARG_KEY_SECAGG_SPEC, spec_doc)
            msg.add_params(MyMessage.MSG_ARG_KEY_SECAGG_THRESHOLD, window.threshold)
            self.send_message(msg)
        self._arm_secagg_deadline(window.window_id)

    def handle_message_secagg_pubkey(self, msg_params: Message) -> None:
        """One member's window public key; once every key is in, send the
        whole directory to every member."""
        co = self._secagg
        window = co.window if co is not None else None
        if window is None or int(msg_params.get(
                MyMessage.MSG_ARG_KEY_SECAGG_WINDOW_ID)) != window.window_id:
            return
        window.register_public_key(msg_params.get_sender_id(),
                                   int(msg_params.get(MyMessage.MSG_ARG_KEY_SECAGG_PUBKEY)))
        if len(window.public_keys) == len(window.cohort):
            directory = {int(r): int(pk) for r, pk in window.public_keys.items()}
            for cid in window.cohort:
                msg = Message(MyMessage.MSG_TYPE_S2C_SECAGG_DIRECTORY, self.get_sender_id(), cid)
                msg.add_params(MyMessage.MSG_ARG_KEY_SECAGG_WINDOW_ID, window.window_id)
                msg.add_params(MyMessage.MSG_ARG_KEY_SECAGG_PUBKEY, directory)
                self.send_message(msg)

    def handle_message_secagg_shares(self, msg_params: Message) -> None:
        """Relay each dealt Shamir share to its holder. The relay is opaque
        routing: a production deployment also encrypts each share under the
        recipient's pair key so this hop cannot read it."""
        dealer = msg_params.get_sender_id()
        wid = int(msg_params.get(MyMessage.MSG_ARG_KEY_SECAGG_WINDOW_ID))
        shares = dict(msg_params.get(MyMessage.MSG_ARG_KEY_SECAGG_SHARES) or {})
        for peer, share in shares.items():
            msg = Message(MyMessage.MSG_TYPE_S2C_SECAGG_SHARE_RELAY, self.get_sender_id(), int(peer))
            msg.add_params(MyMessage.MSG_ARG_KEY_SECAGG_WINDOW_ID, wid)
            msg.add_params(MyMessage.MSG_ARG_KEY_SECAGG_DEALER, int(dealer))
            msg.add_params(MyMessage.MSG_ARG_KEY_SECAGG_SHARE, [int(v) for v in share])
            self.send_message(msg)

    def _arm_secagg_deadline(self, window_id: int) -> None:
        self._cancel_secagg_deadline()
        deadline_s = float(self.aggregator.privacy_cfg.window_deadline_s)
        if deadline_s <= 0:
            return
        t = threading.Timer(deadline_s, self._on_secagg_deadline, args=(window_id,))
        t.daemon = True
        t.start()
        self._secagg_deadline_timer = t

    def _cancel_secagg_deadline(self) -> None:
        if self._secagg_deadline_timer is not None:
            self._secagg_deadline_timer.cancel()
            self._secagg_deadline_timer = None

    def _on_secagg_deadline(self, window_id: int) -> None:
        """Timer thread: the masking window's deadline fired with members
        missing. Below the reveal quorum of arrivals it extends; else it asks
        the survivors to reveal their shares of the dropped members' keys
        (the reveals' handler closes the window) and re-arms, so a starving
        reveal phase refires instead of hanging. Past
        ``window_max_extensions`` firings the window is aborted: its epoch
        is discarded and a fresh window opens over the live members."""
        device = getattr(self.aggregator, "device", None)
        on_card = torch.cuda.device(device) if getattr(device, "type", None) == "cuda" \
            else contextlib.nullcontext()
        with on_card, self._round_lock:
            co = self._secagg
            window = co.window if co is not None else None
            if window is None or window.window_id != window_id or window.closed:
                return  # the window already closed
            dropped = window.missing()
            if not dropped:
                return
            self._secagg_deadline_attempts += 1
            max_ext = int(self.aggregator.privacy_cfg.window_max_extensions)
            if self._secagg_deadline_attempts > max_ext:
                self._secagg_abort_window(co, window, window_id)
                return
            if len(window.arrived) < window.threshold + 1:
                log.warning("secagg window %d: only %d arrivals (< reveal quorum %d), "
                            "extending the deadline (%d/%d)", window_id, len(window.arrived),
                            window.threshold + 1, self._secagg_deadline_attempts, max_ext)
                self._arm_secagg_deadline(window_id)
                return
            for cid in window.arrived:
                msg = Message(MyMessage.MSG_TYPE_S2C_SECAGG_REVEAL_REQUEST,
                              self.get_sender_id(), int(cid))
                msg.add_params(MyMessage.MSG_ARG_KEY_SECAGG_WINDOW_ID, window_id)
                msg.add_params(MyMessage.MSG_ARG_KEY_SECAGG_DROPPED, [int(r) for r in dropped])
                self.send_message(msg)
            # survivors may vanish before revealing: refire (bounded by the
            # same attempts counter) rather than hang
            self._arm_secagg_deadline(window_id)

    def _secagg_abort_window(self, co, window, window_id: int) -> None:
        """Escalation past the extension budget: too few live members to
        ever meet the reveal quorum. Abort (discard the poisoned epoch, book
        ``secagg.windows_failed``) and reopen over the members that proved
        live in this window, falling back to the whole round cohort when
        the survivors cannot form a window of their own. The caller holds
        ``_round_lock``; this runs on the timer thread, so each reopen is
        guarded."""
        arrived = [int(c) for c in window.arrived]
        missing = co.abort_window()
        log.error("secagg window %d: aborted after %d deadline firings (arrived=%s "
                  "missing=%s); discarding the epoch and reopening", window_id,
                  self._secagg_deadline_attempts, arrived, missing)
        cohort = arrived if len(arrived) >= 2 else None
        try:
            self._secagg_open_window(cohort=cohort)
        except Exception:  # noqa: BLE001 - the timer thread must not die with the run's window
            if cohort is None:
                log.exception("secagg window %d: reopen after abort failed", window_id)
                return
            try:
                self._secagg_open_window()
            except Exception:  # noqa: BLE001 - as above
                log.exception("secagg window %d: reopen after abort failed", window_id)

    def handle_message_secagg_reveal(self, msg_params: Message) -> None:
        """One survivor's share bundle. When every dropped rank has its
        reveal quorum, reconstruct and subtract the stray masks and publish
        the partial window (booked on ``quorum.partial`` by the
        coordinator)."""
        with self._round_lock:
            co = self._secagg
            window = co.window if co is not None else None
            if window is None or int(msg_params.get(
                    MyMessage.MSG_ARG_KEY_SECAGG_WINDOW_ID)) != window.window_id:
                return
            reveals = {int(dr): [int(v) for v in share] for dr, share in
                       dict(msg_params.get(MyMessage.MSG_ARG_KEY_SECAGG_REVEALS) or {}).items()}
            window.add_reveal(msg_params.get_sender_id(), reveals)
            if not window.reveals_complete():
                return
            co.recover()  # the shares are in: validates and books the dropouts
            self._cancel_secagg_deadline()
            model = co.close_window()
            if model is None:
                return
            self.aggregator.set_global_model_params(model)
            self._after_async_publish()

    def _save_round_state(self, round_idx: int, global_model_params, *, final: bool = False) -> None:
        """Durable round boundary, owned by the engine's RoundCheckpointer:
        async enqueue, drain-then-sync-save on the final round, mid-window
        buffer snapshots, and both chaos SIGKILL drills."""
        if self._checkpointer is None:
            return
        self._checkpointer.save(
            int(round_idx),
            {"model": global_model_params},
            cohort=self.client_id_list_in_this_round or [],
            health=self.aggregator.fleet.health.export_state(),
            final=final,
            async_buffer=(self.aggregator.async_buffer if self._async_mode else None),
        )

    def _export_fleet_trace_if_configured(self) -> None:
        """Write the fleet Perfetto JSON when ``args.fleet_trace`` names a
        path (and any client telemetry arrived)."""
        path = getattr(self.args, "fleet_trace", None)
        if not path or not self.aggregator.fleet.merges:
            return
        try:
            out = self.aggregator.export_fleet_trace(str(path))
            log.info("fleet trace written to %s (open in ui.perfetto.dev)", out)
        except OSError:
            log.exception("fleet trace export failed")

    def _model_version(self) -> int:
        """The published-model version stamped on every model sync: the
        async buffer's version in async mode, the round index otherwise (one
        publish a round makes them the same synchronously)."""
        buf = getattr(self.aggregator, "async_buffer", None)
        return int(buf.version) if buf is not None else int(self.args.round_idx)

    # --- senders ----------------------------------------------------------
    def send_message_init_config(self, receive_id: int, global_model_params, datasilo_index) -> None:
        message = Message(MyMessage.MSG_TYPE_S2C_INIT_CONFIG, self.get_sender_id(), receive_id)
        message.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, global_model_params)
        message.add_params(MyMessage.MSG_ARG_KEY_CLIENT_INDEX, int(datasilo_index))
        # a resumed server's first round is not round 0: clients adopt this
        message.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX, int(self.args.round_idx))
        message.add_params(MyMessage.MSG_ARG_KEY_MODEL_VERSION, self._model_version())
        self._note_model_broadcast(receive_id, message)
        self.send_message(message)

    def send_message_sync_model_to_client(self, receive_id: int, global_model_params, client_index) -> None:
        message = Message(MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, self.get_sender_id(), receive_id)
        message.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, global_model_params)
        message.add_params(MyMessage.MSG_ARG_KEY_CLIENT_INDEX, int(client_index))
        message.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX, self.args.round_idx)
        message.add_params(MyMessage.MSG_ARG_KEY_MODEL_VERSION, self._model_version())
        self._note_model_broadcast(receive_id, message)
        self.send_message(message)

    def _note_model_broadcast(self, receive_id: int, message: Message) -> None:
        """Remember the broadcast size (the link cost model's payload
        estimate for the symmetric upload) and, under WAN-aware health, when
        this rank's round started on the server's clock."""
        self._last_bcast_nbytes = netlink.payload_nbytes(message)
        if self._link_wan_health:
            self._bcast_sent_mono[int(receive_id)] = time.monotonic()

    def send_finish_to_all(self) -> None:
        for client_id in range(1, self.size):
            message = Message(MyMessage.MSG_TYPE_S2C_FINISH, self.get_sender_id(), client_id)
            self.send_message(message)
