"""FedSeg, federated semantic segmentation: counterpart of
``fedml_tpu/simulation/sp/fedseg.py`` (reference ``simulation/mpi/fedseg/``,
FedSegAPI/FedSegTrainer/FedSegAggregator with the Evaluator's
confusion-matrix metrics, ``utils.py:253-276``).

Each client trains SGD (momentum 0.9) over its shard in whole batches, in
order, on a per-pixel cross-entropy weighted by the shard's inverse class
frequencies; the server FedAvg-folds the clients weighted by the pixels'
images each trained on (whole batches of ``min(batch_size, n)``). The void
label ``seg_ignore_label`` (cityscapes' 255) is masked out of the loss, the
class weights and the confusion matrix. The confusion matrix is a count of
(label, prediction) pairs, exact; the JAX package's one-hot einsum counts
the same pairs in float32, exact below 2^24 pixels.

Two paths, as in the JAX package: the runner's dataset and model
(``pascal_voc`` with ``unet``), or standalone, with its own surrogate
(:func:`make_segmentation_data`, numpy, the JAX package's) and a
``SegNetLite`` drawn from ``random_seed``.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...models.layers import flax_init_
from ...models.segmentation import SegNetLite
from ...utils.pytree import StateDict, stacked_weighted_average, tree_clone

log = logging.getLogger(__name__)


def make_segmentation_data(
    n_clients: int, per_client: int = 16, hw: int = 32, num_classes: int = 3, seed: int = 0,
) -> Tuple[Dict[int, Tuple[np.ndarray, np.ndarray]], Tuple[np.ndarray, np.ndarray]]:
    """A deterministic surrogate for the reference's Pascal-VOC/COCO loaders:
    background, axis-aligned rectangles (class 1) and circles (class 2);
    the image channels carry the class signal plus noise."""
    rng = np.random.default_rng(seed)

    def sample(n):
        ys = np.zeros((n, hw, hw), np.int32)
        xs = rng.normal(0, 0.3, size=(n, hw, hw, 3)).astype(np.float32)
        yy, xx = np.mgrid[0:hw, 0:hw]
        for i in range(n):
            x0, y0 = rng.integers(2, hw // 2, 2)
            w, h = rng.integers(4, hw // 2, 2)
            ys[i, y0: y0 + h, x0: x0 + w] = 1
            cx, cy = rng.integers(hw // 4, 3 * hw // 4, 2).tolist()
            r = int(rng.integers(3, hw // 4))
            circle = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            ys[i][circle] = 2
        for c in range(3):
            xs[..., c] += (ys == c).astype(np.float32)
        return xs, ys

    clients = {c: sample(per_client) for c in range(n_clients)}
    return clients, sample(max(16, per_client))


def confusion_matrix(pred: torch.Tensor, gt: torch.Tensor, num_classes: int) -> torch.Tensor:
    """[C, C] counts of (label, prediction) pairs, int64; a label outside
    [0, C) (the void label) counts nowhere."""
    gt, pred = gt.reshape(-1).long(), pred.reshape(-1).long()
    keep = (gt >= 0) & (gt < num_classes)
    return torch.bincount(gt[keep] * num_classes + pred[keep],
                          minlength=num_classes * num_classes).reshape(num_classes, num_classes)


def segmentation_metrics(cm) -> Dict[str, float]:
    """The reference Evaluator's four metrics from a confusion matrix."""
    cm = np.asarray(cm.cpu() if isinstance(cm, torch.Tensor) else cm, np.float64)
    diag, rows, cols = np.diag(cm), cm.sum(1), cm.sum(0)
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = diag.sum() / cm.sum()
        acc_class = np.nanmean(diag / rows)
        iou = diag / (rows + cols - diag)
        miou = np.nanmean(iou)
        freq = rows / cm.sum()
        fwiou = np.nansum(freq * iou)
    return {"pixel_acc": float(acc), "pixel_acc_class": float(acc_class), "mIoU": float(miou),
            "FWIoU": float(fwiou)}


class FedSegAPI:
    """FedAvg rounds over segmentation clients; each round's metrics are the
    reference's EvaluationMetricsKeeper fields."""

    def __init__(self, args: Any, device: Any = None, dataset=None, model=None,
                 client_trainer=None, server_aggregator=None, num_classes: int = 3):
        from ...device import get_device

        self.args = args
        self.device = get_device(args) if device is None else torch.device(device)
        seed = int(getattr(args, "random_seed", 0))
        if dataset is not None:
            # the runner's tuple: (..., train_local, test_local, class_num)
            train_local, num_classes = dataset[5], int(dataset[7])
            self.clients = {cid: (np.asarray(ds.x), np.asarray(ds.y))
                            for cid, ds in train_local.items()}
            self.test_set = (np.asarray(dataset[3].x), np.asarray(dataset[3].y))
        else:
            n_clients = int(getattr(args, "client_num_in_total", 4))
            self.clients, self.test_set = make_segmentation_data(n_clients, seed=seed)
        self.num_classes = num_classes
        if model is not None and hasattr(model, "module"):
            self.model = model.module  # the runner's FedModel, seeded by args
            self.params = model.params
        else:
            self.model = flax_init_(SegNetLite(num_classes=num_classes),
                                    torch.Generator().manual_seed(seed)).to(self.device)
            self.params = tree_clone(dict(self.model.named_parameters()))
        self.lr = float(getattr(args, "learning_rate", 0.05))
        self.epochs = int(getattr(args, "epochs", 1))
        self.batch = int(getattr(args, "batch_size", 8))
        # the void label (reference SegmentationLosses ignore_index=255); -1: none
        self.ignore = int(getattr(args, "seg_ignore_label", -1))
        self.metrics_history: List[Dict[str, float]] = []
        self.last_confusion: Optional[torch.Tensor] = None  # the last round's, [C, C]

    @property
    def _dtype(self) -> torch.dtype:
        return next(self.model.parameters()).dtype

    def _to_device(self, xs, ys):
        return (torch.from_numpy(np.ascontiguousarray(xs)).to(self.device, self._dtype),
                torch.from_numpy(np.ascontiguousarray(ys)).to(self.device).long())

    def _masked(self, y: torch.Tensor):
        """(y with the void label at 0 for indexing, validity mask or None)."""
        if self.ignore < 0:
            return y, None
        valid = y != self.ignore
        return torch.where(valid, y, 0), valid

    def _pixel_ce(self, logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Per-pixel cross-entropy [B, H, W] of NHWC logits."""
        return F.cross_entropy(logits.permute(0, 3, 1, 2), y, reduction="none")

    def _local_train(self, params: StateDict, xs: torch.Tensor, ys: torch.Tensor
                     ) -> Tuple[StateDict, torch.Tensor]:
        """One client's epochs from ``params`` -> (params, the last step's loss)."""
        module, c = self.model, self.num_classes
        named = dict(module.named_parameters())
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(params[k])
        opt = torch.optim.SGD(list(named.values()), lr=self.lr, momentum=0.9)
        n = xs.shape[0]
        b = min(self.batch, n)  # a shard smaller than one batch shrinks the batch
        nb = max(1, n // b)
        # inverse-frequency class weights (reference SegmentationLosses
        # weighted-CE mode); void pixels go to an overflow bin and are dropped
        flat = ys.reshape(-1)
        if self.ignore >= 0:
            flat = torch.where(flat == self.ignore, c, flat)
        counts = torch.bincount(flat, minlength=c + 1)[:c].to(torch.float32)  # as JAX's
        cw = counts.sum() / (c * counts.clamp_min(1.0))
        loss = torch.zeros((), device=self.device)
        for _ in range(self.epochs):
            for i in range(nb):
                x, y = xs[i * b:(i + 1) * b], ys[i * b:(i + 1) * b]
                y_safe, valid = self._masked(y)
                ce = self._pixel_ce(module(x), y_safe)
                w = cw[y_safe] if valid is None else cw[y_safe] * valid
                denom = ce.numel() if valid is None else valid.sum().clamp_min(1)
                loss = (ce * w).sum() / denom
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
        return {k: p.detach().clone() for k, p in named.items()}, loss.detach()

    @torch.no_grad()
    def _evaluate(self, params: StateDict, xs: torch.Tensor, ys: torch.Tensor):
        logits = torch.func.functional_call(self.model, params, (xs,))
        y_safe, valid = self._masked(ys)
        ce = self._pixel_ce(logits, y_safe)
        loss = ce.mean() if valid is None else (ce * valid).sum() / valid.sum().clamp_min(1)
        # the raw labels: a void label counts nowhere in the matrix
        return confusion_matrix(logits.argmax(-1), ys, self.num_classes), loss

    def train(self) -> Dict[str, float]:
        rounds = int(getattr(self.args, "comm_round", 2))
        test_x, test_y = self._to_device(*self.test_set)
        metrics: Dict[str, float] = {}
        for r in range(rounds):
            updated, weights = [], []
            for xs, ys in self.clients.values():
                p, _loss = self._local_train(self.params, *self._to_device(xs, ys))
                updated.append(p)
                # weight by the images trained on: whole batches of min(batch, n)
                b = min(self.batch, len(xs))
                weights.append(max(1, len(xs) // b) * b)
            w = torch.tensor(weights, dtype=torch.float32, device=self.device)
            self.params = stacked_weighted_average(updated, w / w.sum())
            cm, test_loss = self._evaluate(self.params, test_x, test_y)
            metrics = segmentation_metrics(cm)
            metrics["test_loss"] = float(test_loss)
            metrics["round"] = r
            self.last_confusion = cm
            self.metrics_history.append(metrics)
            log.info("fedseg round %d: %s", r, metrics)
        return metrics
