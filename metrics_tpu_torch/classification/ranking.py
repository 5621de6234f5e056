"""Multilabel ranking module metrics: port of ``metrics_tpu/classification/ranking.py``."""
from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.functional.classification.ranking import (
    _coverage_error_compute,
    _coverage_error_update,
    _label_ranking_average_precision_compute,
    _label_ranking_average_precision_update,
    _label_ranking_loss_compute,
    _label_ranking_loss_update,
)
from metrics_tpu_torch.metric import Metric


class CoverageError(Metric):
    """Multilabel coverage error.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CoverageError
        >>> m = CoverageError(device="cpu")
        >>> m.update(torch.tensor([[0.8, 0.3, 0.6], [0.2, 0.7, 0.4]]), torch.tensor([[1, 0, 1], [0, 1, 0]]))
        >>> float(m.compute())
        1.5
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("coverage", 0.0, dist_reduce_fx="sum")
        self.add_state("numel", 0.0, dist_reduce_fx="sum")
        self.add_state("weight", 0.0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None) -> None:
        coverage, numel, sample_weight = _coverage_error_update(preds, target, sample_weight)
        self.coverage = self.coverage + coverage
        self.numel = self.numel + numel
        if sample_weight is not None:
            self.weight = self.weight + sample_weight

    def compute(self) -> Tensor:
        # the weight state goes in as it is: the denominator is chosen on the device
        return _coverage_error_compute(self.coverage, self.numel, self.weight)


class LabelRankingAveragePrecision(Metric):
    """Label ranking average precision.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import LabelRankingAveragePrecision
        >>> m = LabelRankingAveragePrecision(device="cpu")
        >>> m.update(torch.tensor([[0.8, 0.3, 0.6], [0.2, 0.7, 0.4]]), torch.tensor([[1, 0, 1], [0, 1, 0]]))
        >>> float(m.compute())
        1.0
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("score", 0.0, dist_reduce_fx="sum")
        self.add_state("numel", 0.0, dist_reduce_fx="sum")
        self.add_state("sample_weight", 0.0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None) -> None:
        score, numel, sample_weight = _label_ranking_average_precision_update(preds, target, sample_weight)
        self.score = self.score + score
        self.numel = self.numel + numel
        if sample_weight is not None:
            self.sample_weight = self.sample_weight + sample_weight

    def compute(self) -> Tensor:
        return _label_ranking_average_precision_compute(self.score, self.numel, self.sample_weight)


class LabelRankingLoss(Metric):
    """Label ranking loss.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import LabelRankingLoss
        >>> m = LabelRankingLoss(device="cpu")
        >>> m.update(torch.tensor([[0.8, 0.3, 0.6], [0.2, 0.7, 0.4]]), torch.tensor([[1, 0, 1], [0, 1, 0]]))
        >>> float(m.compute())
        0.0
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("loss", 0.0, dist_reduce_fx="sum")
        self.add_state("numel", 0.0, dist_reduce_fx="sum")
        self.add_state("sample_weight", 0.0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None) -> None:
        loss, numel, sample_weight = _label_ranking_loss_update(preds, target, sample_weight)
        self.loss = self.loss + loss
        self.numel = self.numel + numel
        if sample_weight is not None:
            self.sample_weight = self.sample_weight + sample_weight

    def compute(self) -> Tensor:
        return _label_ranking_loss_compute(self.loss, self.numel, self.sample_weight)
