"""Asynchronous FedAvg simulation (FedAsync-style staleness weighting):
counterpart of ``fedml_tpu/simulation/sp/async_fedavg.py`` (reference
``simulation/mpi/async_fedavg/``).

Clients return updates whenever they finish; the server mixes each arrival
into the global model at once instead of waiting for the cohort. A
single-process discrete-event loop: completion times come from a numpy
``RandomState(random_seed)`` per (client, dispatch), bit for bit the JAX
package's, events are processed in completion order, and each arrival
applies

    w_global <- (1 - a_t) * w_global + a_t * w_client,
    a_t = alpha * (staleness + 1)^(-poly_a)

(Xie et al., "Asynchronous Federated Optimization"). The client then
re-dispatches on the fresh global model, keeping ``client_num_per_round``
clients in flight.

A legacy front in the JAX package: per-arrival mixing has no round boundary
and no buffer, so neither the engine's loop nor its async sinks describe
it; the maintained async path is the buffered one (``async_rounds``).
Cohort defenses are off around each arrival, with one warning (JAX
``async_fedavg.py:55-90``); the DP and attack hooks still run.
"""

from __future__ import annotations

import heapq
import logging
from typing import Any, Dict, List, Tuple

import numpy as np

from .fedavg_api import FedAvgAPI

log = logging.getLogger(__name__)


class AsyncFedAvgAPI(FedAvgAPI):
    _warned_agg_defense = False

    class _defender_disabled:
        """Cohort defenses (aggregation rules, paired before/after
        re-centering like CClip's) are undefined on one arrival: the
        defender is off around the per-arrival hooks; DP and attacker hooks
        still run."""

        def __enter__(self):
            from ...core.security.fedml_defender import FedMLDefender

            self.defender = FedMLDefender.get_instance()
            self.was_enabled = self.defender.is_enabled
            self.defender.is_enabled = False
            return self

        def __exit__(self, *exc):
            self.defender.is_enabled = self.was_enabled
            return False

    def _warn_defenses_unsupported(self) -> None:
        if AsyncFedAvgAPI._warned_agg_defense:
            return
        from ...core.security.fedml_defender import FedMLDefender

        defender = FedMLDefender.get_instance()
        if defender.is_defense_enabled():
            log.warning("async FedAvg mixes one update at a time: cohort defense %s cannot "
                        "apply to single arrivals and is DISABLED for this run",
                        type(defender.defender).__name__)
        AsyncFedAvgAPI._warned_agg_defense = True

    def train(self) -> Dict[str, float]:
        args = self.args
        w_global = self.model_trainer.get_model_params()
        n_total = int(args.client_num_in_total)
        in_flight = min(int(args.client_num_per_round), n_total)
        total_updates = int(getattr(args, "comm_round", 10)) * in_flight
        alpha = float(getattr(args, "async_alpha", 0.6))
        poly_a = float(getattr(args, "async_staleness_exponent", 0.5))
        freq = int(getattr(args, "frequency_of_the_test", 5))
        rng = np.random.RandomState(int(getattr(args, "random_seed", 0)))

        # event queue: (completion_time, seq, client_idx, dispatch_version);
        # the model each dispatch started from, by seq (state dicts are never
        # written in place: every mix makes a new one)
        events: List[Tuple[float, int, int, int]] = []
        dispatched_w: Dict[int, Any] = {}
        seq = 0
        version = 0

        def dispatch(client_idx: int, now: float) -> None:
            nonlocal seq
            delay = 1.0 + rng.exponential(float(getattr(args, "async_mean_delay", 1.0)))
            heapq.heappush(events, (now + delay, seq, client_idx, version))
            dispatched_w[seq] = w_global
            seq += 1

        for c in rng.choice(n_total, in_flight, replace=False):
            dispatch(int(c), 0.0)

        client = self.client_list[0]
        processed = 0
        staleness = 0
        while events and processed < total_updates:
            now, ev_seq, client_idx, started_version = heapq.heappop(events)
            client.update_local_dataset(
                client_idx,
                self.train_data_local_dict[client_idx],
                self.test_data_local_dict[client_idx],
                self.train_data_local_num_dict[client_idx],
            )
            w_local = client.train(dispatched_w.pop(ev_seq))
            # each arrival is one aggregation event between the alg-frame
            # hooks, cohort defenses off
            self._warn_defenses_unsupported()
            sample_num = float(self.train_data_local_num_dict[client_idx])
            with self._defender_disabled():
                hooked = self.aggregator.on_before_aggregation([(sample_num, w_local)])
                if not hooked:
                    dispatch(int(rng.randint(n_total)), now)
                    continue
                w_local = hooked[0][1]
                staleness = version - started_version
                a_t = alpha * (staleness + 1.0) ** (-poly_a)
                w_global = {k: (1.0 - a_t) * g + a_t * w_local[k] for k, g in w_global.items()}
                w_global = self.aggregator.on_after_aggregation(w_global)
            version += 1
            processed += 1
            if processed % in_flight == 0:
                self._install_global(w_global)
                round_idx = processed // in_flight - 1
                if freq > 0 and round_idx % freq == 0:
                    m = self._test_global(round_idx)
                    m["staleness_last"] = float(staleness)
                    self.metrics_history.append(m)
            # keep the worker busy: re-dispatch on the fresh model
            dispatch(int(rng.randint(n_total)), now)

        self._install_global(w_global)
        self.metrics_history.append(self._test_global(processed // max(in_flight, 1)))
        return self.metrics_history[-1]
