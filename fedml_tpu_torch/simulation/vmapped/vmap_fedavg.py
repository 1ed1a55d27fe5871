"""The client-batched ("vmapped") FedAvg simulator: counterpart of
``fedml_tpu/simulation/vmapped/vmap_fedavg.py``.

All sampled clients' local training runs as one client-batched program
(``ml/trainer/local_sgd.py`` :func:`make_vmapped_local_train_fn`): the
client axis becomes a batch axis, so a step's kernels are issued once for
the whole cohort, not once per client. The fold reads the stacked ``[K, ...]``
leaves directly (``BucketedAggregator.aggregate_stacked``).

Client shards are padded to the cohort's largest with zero rows, and the
batch count to the cohort's largest with zero index rows and zero masks, so
non-IID shards of any size batch together. As in the JAX package, the
shuffle seed of a client is ``random_seed + k`` with ``k`` its position in
the cohort (not its id), so every round repeats the same shuffles, and the
server rule is the plain sample-weighted fold (no FedOpt step). With an
attack, defense, DP or contribution middleware on, the fold unstacks the
clients for the server's hooks and assesses contribution after it
(``StackedBucketedSink``); the client-side middleware is refused
(:func:`refuse_client_hooks`).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List

import numpy as np
import torch

from ...core.alg_frame.context import Context
from ...core.engine import RoundEngine, StackedBucketedSink, VmappedMegabatchStrategy, sample_cohort
from ...ml.aggregator import create_server_aggregator
from ...ml.trainer.local_sgd import epoch_index_array, make_vmapped_local_train_fn

log = logging.getLogger(__name__)


def _pad(a: np.ndarray, n: int, axis: int = 0) -> np.ndarray:
    """``a`` with zeros appended along ``axis`` up to length ``n``."""
    if a.shape[axis] == n:
        return a
    shape = list(a.shape)
    shape[axis] = n - a.shape[axis]
    return np.concatenate([a, np.zeros(shape, a.dtype)], axis=axis)


def refuse_client_hooks(args: Any) -> None:
    """The vmapped front trains every client in one program and runs no
    client hook, in the JAX package too (its ``VmappedMegabatchStrategy``
    never calls ``on_before_local_training`` or ``on_after_local_training``):
    JAX draws no local noise for ldp, nbafl or dp_clip and poisons no data
    there, while its LDP accountant still counts the noise. The port refuses
    those knobs before any round (ROADMAP.md, Queue 3, R7), and FHE, whose
    encryption is a client hook (JAX's vmapped front never encrypts).
    Server-side middleware (cdp, model attacks, every defense) runs."""
    from ...core.dp.fedml_differential_privacy import LOCAL_SOLUTIONS, dp_solution
    from ...core.fhe.fhe_agg import refuse_fhe_front
    from ...core.security.fedml_attacker import DATA_ATTACKS, attack_type

    refuse_fhe_front(args, "vmap")
    bad = []
    if dp_solution(args) in LOCAL_SOLUTIONS:
        bad.append(f"dp_solution_type={dp_solution(args)!r}")
    if attack_type(args) in DATA_ATTACKS:
        bad.append(f"attack_type={attack_type(args)!r}")
    if bad:
        raise ValueError(
            f"{', '.join(bad)}: the vmapped front runs no client hook, so this client-side "
            "middleware would never act (the JAX package skips it silently and still "
            "accounts LDP noise it never drew; ROADMAP.md, Queue 3, R7). Use backend 'sp'.")


class VmapFedAvgAPI:
    def __init__(self, args: Any, device: Any, dataset, model):
        refuse_client_hooks(args)
        self.args = args
        self.device = device
        [
            self.train_data_num,
            self.test_data_num,
            self.train_global,
            self.test_global,
            self.train_data_local_num_dict,
            self.train_data_local_dict,
            self.test_data_local_dict,
            self.class_num,
        ] = dataset
        self.model = model
        self.aggregator = create_server_aggregator(model, args)
        Context().add(Context.KEY_TEST_DATA, self.test_global)
        self.metrics_history: List[Dict[str, float]] = []
        self._vmapped_train = make_vmapped_local_train_fn(model, args)

    # --- data staging -----------------------------------------------------
    def _stack_clients(self, client_indexes: List[int], first: int = 0, nb_max: int = 0,
                       device=None):
        """The cohort's shards padded to a common N and stacked, with their
        index and mask arrays padded to a common batch count, on the device:
        ``x [K, N, ...]``, ``y [K, N, ...]``, ``idx`` (int32) and ``mask``
        (f32) ``[K, E, nb, B]``. A slice of a cohort (the collective
        simulator's groups) passes its position in the cohort, ``first`` (the
        shuffle seeds follow it), the whole cohort's batch count ``nb_max``
        and its group's ``device``."""
        shards = [self.train_data_local_dict[i] for i in client_indexes]
        n_max = max(len(s) for s in shards)
        bs = int(getattr(self.args, "batch_size", 32))
        epochs = int(getattr(self.args, "epochs", 1))
        seed = int(getattr(self.args, "random_seed", 0)) + int(first)
        # over each shard's real n: padded rows are never drawn
        arrays = [epoch_index_array(len(s), bs, epochs, seed + k) for k, s in enumerate(shards)]
        nb_max = max([nb_max] + [idx.shape[1] for idx, _ in arrays])
        xs = [_pad(s.x, n_max) for s in shards]
        ys = [_pad(s.y, n_max) for s in shards]
        idxs = [_pad(idx, nb_max, axis=1) for idx, _ in arrays]
        masks = [_pad(mask, nb_max, axis=1) for _, mask in arrays]
        dev = self.model.device if device is None else device
        return tuple(torch.from_numpy(np.stack(a)).to(dev) for a in (xs, ys, idxs, masks))

    def _client_sampling(self, round_idx: int, client_num_in_total: int,
                         client_num_per_round: int) -> List[int]:
        return sample_cohort(round_idx, client_num_in_total, client_num_per_round)

    # --- driver -----------------------------------------------------------
    def train(self) -> Dict[str, float]:
        """One engine run: the vmapped megabatch strategy feeds the stacked
        bucketed sink."""
        engine = RoundEngine(
            self.args,
            VmappedMegabatchStrategy(self),
            StackedBucketedSink(self.aggregator),
            sample_fn=lambda r: self._client_sampling(
                r, int(self.args.client_num_in_total), int(self.args.client_num_per_round)
            ),
            install_fn=self.aggregator.set_model_params,
            eval_fn=self._test_global,
            round_span_attrs={"optimizer": "FedAvg", "front": "vmapped"},
            metrics_history=self.metrics_history,
        )
        w_global = engine.run(self.model.params)
        self.model = dataclasses.replace(self.model, params=w_global)
        return self.metrics_history[-1] if self.metrics_history else {}

    def _test_global(self, round_idx: int) -> Dict[str, float]:
        metrics = self.aggregator.test(self.test_global, self.device, self.args)
        metrics["round"] = round_idx
        log.info("vmap sim round %d: %s", round_idx,
                 {k: round(float(v), 4) for k, v in metrics.items()})
        return metrics
