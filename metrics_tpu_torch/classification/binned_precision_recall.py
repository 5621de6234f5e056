"""Binned (constant-memory, fixed-shape) precision-recall metrics.

Port of ``metrics_tpu/classification/binned_precision_recall.py``. The state
is three ``(C, T)`` float32 count arrays, and an update is one launch of the
``binned_stats`` kernel over every class and threshold at once. An update
makes no host sync: it has no input checks and no data-dependent shapes.

The counts are float32, as in the JAX package: a count stays exact while it
is below 2^24 (16,777,216) rows.
"""
from typing import Any, List, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.average_precision import (
    _average_precision_compute_with_precision_recall,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops import binned_stat_scores
from metrics_tpu_torch.utilities.data import to_onehot

METRIC_EPS = 1e-6


def _linspace_thresholds(num: int, device: Optional[torch.device] = None) -> Tensor:
    """``jnp.linspace(0, 1, num)`` in float32, bit for bit.

    XLA computes it as ``float32(iota(num - 1)) * float32(1 / (num - 1))``
    with the last value set to 1.0; ``torch.linspace`` rounds otherwise
    (1 of 100 values differs at ``num = 100``), and a score equal to a
    threshold would then count differently.
    """
    if num < 2:
        return torch.zeros(num, dtype=torch.float32, device=device)
    step = torch.tensor(1.0, dtype=torch.float32) / (num - 1)
    grid = torch.arange(num - 1, dtype=torch.float32) * step
    return torch.cat([grid, torch.ones(1, dtype=torch.float32)]).to(device)


def _recall_at_precision(
    precision: Tensor,
    recall: Tensor,
    thresholds: Tensor,
    min_precision: float,
) -> Tuple[Tensor, Tensor]:
    """Best recall subject to ``precision >= min_precision``.

    Ties are broken lexicographically by (recall, precision, threshold),
    as three nested masked maxima.
    """
    n = thresholds.shape[0]  # precision/recall carry one extra appended point
    r, p, t = recall[:n], precision[:n], thresholds
    valid = p >= min_precision

    max_r = torch.max(torch.where(valid, r, -torch.inf))
    tie_r = valid & (r == max_r)
    max_p = torch.max(torch.where(tie_r, p, -torch.inf))
    tie_rp = tie_r & (p == max_p)
    best_t = torch.max(torch.where(tie_rp, t, -torch.inf))

    max_recall = torch.where(torch.isfinite(max_r), max_r, 0.0)
    best_threshold = torch.where(max_recall == 0.0, 1e6, torch.where(torch.isfinite(best_t), best_t, 0.0))
    return max_recall, best_threshold


class BinnedPrecisionRecallCurve(Metric):
    """Precision-recall pairs at fixed thresholds, in constant memory.

    ``thresholds`` is a count (that many evenly spaced in ``[0, 1]``, the
    float32 values of ``jnp.linspace``), a list of floats or a tensor; it
    lives on the metric's device.

    Example (binary case):
        >>> import torch
        >>> from metrics_tpu_torch import BinnedPrecisionRecallCurve
        >>> pred = torch.tensor([0, 0.1, 0.8, 0.4])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> pr_curve = BinnedPrecisionRecallCurve(num_classes=1, thresholds=5, device="cpu")
        >>> precision, recall, thresholds = pr_curve(pred, target)
        >>> torch.round(precision, decimals=2)
        tensor([0.5000, 0.5000, 1.0000, 1.0000, 1.0000, 1.0000])
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False
    _device_attributes = ("thresholds",)

    def __init__(
        self,
        num_classes: int,
        thresholds: Union[int, Tensor, List[float]] = 100,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        if isinstance(thresholds, int):
            self.num_thresholds = thresholds
            self.thresholds = _linspace_thresholds(thresholds, self.device)
        elif thresholds is not None:
            if not isinstance(thresholds, (list, Tensor)):
                raise ValueError("Expected argument `thresholds` to either be an integer, list of floats or a tensor")
            if isinstance(thresholds, list):
                thresholds = torch.tensor(thresholds, dtype=torch.float32)
            self.thresholds = thresholds.detach().to(device=self.device, dtype=torch.float32)
            self.num_thresholds = self.thresholds.numel()

        for name in ("TPs", "FPs", "FNs"):
            self.add_state(
                name=name,
                default=torch.zeros((num_classes, self.num_thresholds), dtype=torch.float32),
                dist_reduce_fx="sum",
            )

    def update(self, preds: Tensor, target: Tensor) -> None:
        """One ``binned_stats`` launch over all classes and thresholds."""
        if preds.ndim == target.ndim == 1:
            preds = preds.reshape(-1, 1)
            target = target.reshape(-1, 1)

        if preds.ndim == target.ndim + 1:
            target = to_onehot(target, num_classes=self.num_classes)

        tp, fp, fn = binned_stat_scores(preds, target, self.thresholds)
        self.TPs = self.TPs + tp
        self.FPs = self.FPs + fp
        self.FNs = self.FNs + fn

    def compute(self) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
        """PR pairs with the guaranteed ``(p=1, r=0)`` end point."""
        precisions = (self.TPs + METRIC_EPS) / (self.TPs + self.FPs + METRIC_EPS)
        recalls = self.TPs / (self.TPs + self.FNs + METRIC_EPS)

        ones = torch.ones((self.num_classes, 1), dtype=precisions.dtype, device=precisions.device)
        precisions = torch.cat([precisions, ones], dim=1)
        recalls = torch.cat([recalls, torch.zeros_like(ones)], dim=1)
        if self.num_classes == 1:
            return precisions[0, :], recalls[0, :], self.thresholds
        return list(precisions), list(recalls), [self.thresholds for _ in range(self.num_classes)]


class BinnedAveragePrecision(BinnedPrecisionRecallCurve):
    """Average precision from the binned PR curve.

    Example (binary case):
        >>> import torch
        >>> from metrics_tpu_torch import BinnedAveragePrecision
        >>> pred = torch.tensor([0, 1, 2, 3], dtype=torch.float32)
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> average_precision = BinnedAveragePrecision(num_classes=1, thresholds=10, device="cpu")
        >>> round(float(average_precision(pred, target)), 4)
        1.0
    """

    def compute(self) -> Union[List[Tensor], Tensor]:
        precisions, recalls, _ = super().compute()
        return _average_precision_compute_with_precision_recall(precisions, recalls, self.num_classes, average=None)


class BinnedRecallAtFixedPrecision(BinnedPrecisionRecallCurve):
    """Highest recall at a minimum precision, and the threshold that gives it.

    Example (binary case):
        >>> import torch
        >>> from metrics_tpu_torch import BinnedRecallAtFixedPrecision
        >>> pred = torch.tensor([0, 0.2, 0.5, 0.8])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> average_precision = BinnedRecallAtFixedPrecision(
        ...     num_classes=1, thresholds=10, min_precision=0.5, device="cpu")
        >>> tuple(round(float(x), 4) for x in average_precision(pred, target))
        (1.0, 0.1111)
    """

    def __init__(
        self,
        num_classes: int,
        min_precision: float,
        thresholds: Union[int, Tensor, List[float]] = 100,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes=num_classes, thresholds=thresholds, **kwargs)
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:
        precisions, recalls, thresholds = super().compute()

        if self.num_classes == 1:
            return _recall_at_precision(precisions, recalls, thresholds, self.min_precision)

        # one small reduction per class, as in the JAX package
        recalls_at_p = []
        thresholds_at_p = []
        for i in range(self.num_classes):
            r, t = _recall_at_precision(precisions[i], recalls[i], thresholds[i], self.min_precision)
            recalls_at_p.append(r)
            thresholds_at_p.append(t)
        return torch.stack(recalls_at_p), torch.stack(thresholds_at_p)
