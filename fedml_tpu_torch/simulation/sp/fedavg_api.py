"""Single-process FL simulation: counterpart of
``fedml_tpu/simulation/sp/fedavg_api.py`` (reference
``simulation/sp/fedavg/fedavg_api.py:14``).

One simulator covers FedAvg, FedProx, FedOpt, FedNova, SCAFFOLD, FedDyn and
Mime: the trainer factory picks the local algorithm and ``_server_update``
applies the matching server rule. The round loop is the engine's
(``core/engine``), with the reference's cohort sampling. One ``Client``
object per cohort slot shares the one trainer, whose module holds the model
on the device; the global model and the server state (SCAFFOLD's ``c``,
FedDyn's ``h``, Mime's momentum ``s``) travel as state dicts on that device.

Durable round state (``resilience_dir``, JAX ``:106-115``, ``:138-195``):
each round boundary is saved async through the engine's
``RoundCheckpointer`` (the model, SCAFFOLD's ``c``, FedDyn's ``h``, Mime's
``s`` and the FedOpt server state, with the numpy RNG and the trainer's
round counter in the sidecar), the final round synchronously; ``resume``
restarts from the last complete round and replays the rest bit for bit.

``client_execution: pipelined`` (JAX ``:196-209``) runs the cohort through
the staged pipeline (``core/pipeline``): one client trains while the last
one's upload compresses and folds, folded at arrival for plain FedAvg
(bit-exact with the sequential round), else in pairs mode behind the same
``AlgFrameSink``. Any other value than ``sequential`` and ``pipelined``
raises NotImplementedError.

Modelwatch (JAX ``:93-104``, ``:288-308``), on unless ``FEDML_MODELWATCH=0``
or ``modelwatch_disable``: the weight-space server rule (FedAvg, FedProx,
FedOpt, and pipelined pairs mode, which runs through it) screens each
cohort against the round's global model before the fold, with
``modelwatch_quarantine`` dropping outliers and NaN uploads, and after
``on_after_aggregation`` folds the round's rows into the simulator's
contribution ledger, the process's active one while ``train`` runs.
FedNova, SCAFFOLD, Mime and FedDyn have their own server rules and are not
watched, nor is pipelined fold-at-arrival, as in JAX.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

from ...constants import (
    FEDML_FEDERATED_OPTIMIZER_FEDDYN,
    FEDML_FEDERATED_OPTIMIZER_FEDNOVA,
    FEDML_FEDERATED_OPTIMIZER_FEDOPT,
    FEDML_FEDERATED_OPTIMIZER_MIME,
    FEDML_FEDERATED_OPTIMIZER_SCAFFOLD,
)
from ...core.aggregation.agg_operator import fednova_aggregate, scaffold_aggregate, uniform_average
from ...core.aggregation.server_optimizer import FedOptServer, create_fedopt_server
from ...core.alg_frame.context import Context
from ...core.engine import (AlgFrameSink, InProcessSequentialStrategy, RoundCheckpointer,
                            RoundEngine, sample_cohort)
from ...core.resilience import RoundStateStore
from ...core.resilience.round_state import restore_numpy_rng
from ...core.telemetry import modelwatch
from ...ml.aggregator import create_server_aggregator
from ...ml.trainer.trainer_creator import create_model_trainer
from ...utils.pytree import tree_sub, tree_zeros_like
from .client import Client

log = logging.getLogger(__name__)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to fedml_tpu_torch yet (see ROADMAP.md, Queue 1)")


class FedAvgAPI:
    def __init__(self, args: Any, device: Any, dataset, model, client_trainer=None,
                 server_aggregator=None):
        if str(getattr(args, "client_execution", "sequential") or "sequential") \
                not in ("sequential", "pipelined"):
            raise _not_ported(f"client_execution={args.client_execution!r}")
        self.device = device
        self.args = args
        [
            train_data_num,
            test_data_num,
            train_data_global,
            test_data_global,
            train_data_local_num_dict,
            train_data_local_dict,
            test_data_local_dict,
            class_num,
        ] = dataset
        self.train_global = train_data_global
        self.test_global = test_data_global
        self.train_data_num_in_total = train_data_num
        self.test_data_num_in_total = test_data_num
        self.train_data_local_num_dict = train_data_local_num_dict
        self.train_data_local_dict = train_data_local_dict
        self.test_data_local_dict = test_data_local_dict
        self.class_num = class_num
        self.fed_opt = str(getattr(args, "federated_optimizer", "FedAvg"))

        self.model_trainer = client_trainer or create_model_trainer(model, args)
        self.aggregator = server_aggregator or create_server_aggregator(model, args)
        Context().add(Context.KEY_TEST_DATA, self.test_global)

        self.client_list: List[Client] = []
        self._setup_clients(train_data_local_num_dict, train_data_local_dict, test_data_local_dict)

        self._fedopt_server: Optional[FedOptServer] = None
        if self.fed_opt == FEDML_FEDERATED_OPTIMIZER_FEDOPT:
            self._fedopt_server = create_fedopt_server(args, self.model_trainer.get_model_params())
        self._scaffold_c = tree_zeros_like(self.model_trainer.get_model_params())
        self._feddyn_h = tree_zeros_like(self.model_trainer.get_model_params())
        self._mime_s = tree_zeros_like(self.model_trainer.get_model_params())
        self.metrics_history: List[Dict[str, float]] = []

        # modelwatch: fold-boundary delta stats and the contribution ledger
        # for the weight-space server rule
        self._mw_ledger: Optional[modelwatch.ContributionLedger] = None
        self._mw_prev_update = None
        self._mw_round = 0
        if modelwatch.enabled(args):
            self._mw_ledger = modelwatch.ContributionLedger()
            modelwatch.set_active(self._mw_ledger)

        # durable round state: every round boundary is checkpointed async;
        # args.resume restarts from the last complete round
        self._round_store: Optional[RoundStateStore] = None
        self._checkpointer: Optional[RoundCheckpointer] = None
        rdir = getattr(args, "resilience_dir", None)
        if rdir:
            self._round_store = RoundStateStore(str(rdir))
            self._checkpointer = RoundCheckpointer(self._round_store, args)

    def _setup_clients(self, train_data_local_num_dict, train_data_local_dict,
                       test_data_local_dict) -> None:
        """One Client object per sampled slot, reused across rounds (local
        datasets swapped in per round)."""
        for client_idx in range(int(self.args.client_num_per_round)):
            c = Client(
                client_idx,
                train_data_local_dict[client_idx],
                test_data_local_dict[client_idx],
                train_data_local_num_dict[client_idx],
                self.args,
                self.device,
                self.model_trainer,
            )
            self.client_list.append(c)

    def _client_sampling(self, round_idx: int, client_num_in_total: int,
                         client_num_per_round: int) -> List[int]:
        return sample_cohort(round_idx, client_num_in_total, client_num_per_round)

    # --- durable round state ------------------------------------------
    def _round_state_dict(self, w_global) -> Dict[str, Any]:
        """The named state a round boundary persists: the global model plus
        whichever server-side algorithm state this optimizer carries."""
        st: Dict[str, Any] = {"model": w_global}
        if self.fed_opt == FEDML_FEDERATED_OPTIMIZER_SCAFFOLD:
            st["scaffold_c"] = self._scaffold_c
        elif self.fed_opt == FEDML_FEDERATED_OPTIMIZER_FEDDYN:
            st["feddyn_h"] = self._feddyn_h
        elif self.fed_opt == FEDML_FEDERATED_OPTIMIZER_MIME:
            st["mime_s"] = self._mime_s
        if self._fedopt_server is not None:
            st["fedopt"] = self._fedopt_server.state
        return st

    def _try_resume(self, w_global) -> Tuple[Any, int]:
        """Restore ``(w_global, start_round)`` from the round store when
        ``args.resume`` is set; ``(w_global, 0)`` otherwise."""
        if self._round_store is None or not getattr(self.args, "resume", False):
            return w_global, 0
        rs = self._round_store.resume(template=self._round_state_dict(w_global))
        if rs is None:
            return w_global, 0
        st = rs.state
        w_global = st["model"]
        if "scaffold_c" in st:
            self._scaffold_c = st["scaffold_c"]
        if "feddyn_h" in st:
            self._feddyn_h = st["feddyn_h"]
        if "mime_s" in st:
            self._mime_s = st["mime_s"]
        if self._fedopt_server is not None and "fedopt" in st:
            self._fedopt_server.state = st["fedopt"]
        restore_numpy_rng(rs.meta.get("numpy_rng"))
        tr = rs.meta.get("trainer_round")
        if tr is not None and hasattr(self.model_trainer, "_round"):
            self.model_trainer._round = int(tr)
        self._install_global(w_global)
        log.info("resumed after round %d (%s)", rs.round_idx, self._round_store.directory)
        return w_global, rs.round_idx + 1

    def _save_round_state(self, round_idx: int, w_global, cohort: List[int], final: bool) -> None:
        """Round-boundary durability through the engine's RoundCheckpointer
        (drain-then-sync-save on the final round, the chaos SIGKILL drill)."""
        self._checkpointer.save(
            int(round_idx),
            self._round_state_dict(w_global),
            cohort=cohort,
            extra_meta={"trainer_round": getattr(self.model_trainer, "_round", None)},
            final=final,
        )

    def _build_execution(self):
        """Strategy + sink for the engine. ``client_execution: pipelined``
        swaps in the staged pipeline (core.pipeline): train/compress/fold
        overlap across the cohort, fold-at-arrival when the optimizer's
        semantics allow it (plain FedAvg, no middleware), else pairs mode
        behind the same AlgFrameSink as the sequential path."""
        mode = str(getattr(self.args, "client_execution", "sequential") or "sequential")
        if mode == "pipelined":
            # lazy: core.pipeline pulls aggregation and compression, and the
            # engine package stays an import-time leaf
            from ...core.pipeline import build_pipelined_execution

            return build_pipelined_execution(self)
        return InProcessSequentialStrategy(self), AlgFrameSink(self._server_update)

    def train(self) -> Dict[str, float]:
        strategy, sink = self._build_execution()
        engine = RoundEngine(
            self.args,
            strategy,
            sink,
            sample_fn=lambda r: self._client_sampling(
                r, int(self.args.client_num_in_total), int(self.args.client_num_per_round)
            ),
            install_fn=self._install_global,
            eval_fn=self._test_global,
            resume_fn=self._try_resume,
            checkpoint_fn=self._save_round_state if self._checkpointer is not None else None,
            finalize_fn=(lambda w: self._round_store.wait()) if self._round_store is not None else None,
            round_span_attrs={"optimizer": self.fed_opt},
            metrics_history=self.metrics_history,
        )
        try:
            engine.run(self.model_trainer.get_model_params())
        finally:
            if self._mw_ledger is not None:
                modelwatch.clear_active(self._mw_ledger)
        return self.metrics_history[-1] if self.metrics_history else {}

    def _install_global(self, w_global) -> None:
        self.model_trainer.set_model_params(w_global)
        self.aggregator.set_model_params(w_global)

    def _server_update(self, w_global, w_locals):
        """Apply the per-algorithm server rule with the alg-frame hooks
        around it, as the JAX package runs them. Structured payloads (FedNova
        ``(a_i, d_i)``, SCAFFOLD ``(dw, dc)``) do not pass through the
        weight-space before-hooks: FedNova takes the after-hook only,
        SCAFFOLD no hook."""
        agg = self.aggregator
        if self.fed_opt == FEDML_FEDERATED_OPTIMIZER_FEDNOVA:
            # d_i = (w_global - w_local)/a_i already carries lr
            new_w = fednova_aggregate(w_global, w_locals)
            new_w = agg.on_after_aggregation(new_w)
        elif self.fed_opt == FEDML_FEDERATED_OPTIMIZER_SCAFFOLD:
            new_w, self._scaffold_c = scaffold_aggregate(
                w_global,
                self._scaffold_c,
                w_locals,
                int(self.args.client_num_in_total),
                float(getattr(self.args, "server_lr", 1.0)),
            )
        elif self.fed_opt == FEDML_FEDERATED_OPTIMIZER_MIME:
            weight_payloads = [(n, p[0]) for n, p in w_locals]
            grad_payloads = [p[1] for _, p in w_locals]
            lst = agg.on_before_aggregation(weight_payloads)
            new_w = agg.aggregate(lst)
            new_w = agg.on_after_aggregation(new_w)
            beta = float(getattr(self.args, "mime_beta", 0.9))
            avg_grad = uniform_average(grad_payloads)
            self._mime_s = {k: beta * s + (1 - beta) * avg_grad[k] for k, s in self._mime_s.items()}
        elif self.fed_opt == FEDML_FEDERATED_OPTIMIZER_FEDDYN:
            lst = agg.on_before_aggregation(w_locals)
            alpha = float(getattr(self.args, "feddyn_alpha", 0.01))
            avg_w = uniform_average([w for _, w in lst])
            m = int(self.args.client_num_in_total)
            # the uniform mean of (w_i - g) is mean(w_i) - g
            delta = tree_sub(avg_w, w_global)
            frac = len(lst) / float(m)
            self._feddyn_h = {k: h - alpha * frac * delta[k] for k, h in self._feddyn_h.items()}
            new_w = {k: w - self._feddyn_h[k] / alpha for k, w in avg_w.items()}
            new_w = agg.on_after_aggregation(new_w)
        else:
            lst = agg.on_before_aggregation(w_locals)
            watch = self._mw_session(w_global)
            if watch is not None:
                lst = modelwatch.screen_cohort(
                    watch, lst, list(range(len(lst))), ledger=self._mw_ledger,
                    quarantine=modelwatch.quarantine_enabled(self.args))
            new_w = agg.aggregate(lst)
            if self._fedopt_server is not None:
                new_w = self._fedopt_server.apply(w_global, new_w)
            new_w = agg.on_after_aggregation(new_w)
            if watch is not None:
                self._mw_observe(watch, new_w)
        agg.assess_contribution()
        return new_w

    def _mw_session(self, w_global) -> Optional[modelwatch.WatchSession]:
        """The round's watch session over the current global params, or None
        when modelwatch is off or the model has object leaves (FHE)."""
        if self._mw_ledger is None or modelwatch.has_object_leaves(w_global):
            return None
        return modelwatch.WatchSession(w_global, prev_update=self._mw_prev_update)

    def _mw_observe(self, watch: modelwatch.WatchSession, new_w) -> None:
        """Finish the round's stats into the ledger. A failure here is logged
        with its traceback and leaves the round's model as it is, as in JAX
        (the statistics never change the fold)."""
        try:
            stats = watch.finish(new_w)
            self._mw_prev_update = stats.update_tree
            self._mw_ledger.observe_round(self._mw_round, stats)
        except Exception:  # noqa: BLE001 - logged below; stats must not fail the round
            log.warning("modelwatch: round %d's stats failed", self._mw_round, exc_info=True)
        self._mw_round += 1

    def _test_global(self, round_idx: int) -> Dict[str, float]:
        metrics = self.aggregator.test(self.test_global, self.device, self.args)
        metrics["round"] = round_idx
        log.info("round %d: %s", round_idx, {k: round(float(v), 4) for k, v in metrics.items()})
        return metrics
