"""Precision and Recall module metrics: port of ``metrics_tpu/classification/precision_recall.py``."""
from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.stat_scores import StatScores
from metrics_tpu_torch.functional.classification.precision_recall import _precision_compute, _recall_compute

_ALLOWED_AVERAGE = ["micro", "macro", "weighted", "samples", "none", None]


class _AveragedStatScores(StatScores):
    """``StatScores`` reduced as ``average`` asks: the base of the precision,
    recall, F-beta and specificity modules."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: Optional[str] = "micro",
        mdmc_average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        if average not in _ALLOWED_AVERAGE:
            raise ValueError(f"The `average` has to be one of {_ALLOWED_AVERAGE}, got {average}.")
        super().__init__(
            reduce="macro" if average in ["weighted", "none", None] else average,
            mdmc_reduce=mdmc_average,
            threshold=threshold,
            top_k=top_k,
            num_classes=num_classes,
            multiclass=multiclass,
            ignore_index=ignore_index,
            **kwargs,
        )
        self.average = average


class Precision(_AveragedStatScores):
    """Precision: tp / (tp + fp).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Precision
        >>> precision = Precision(average='macro', num_classes=3, device="cpu")
        >>> round(float(precision(torch.tensor([2, 0, 2, 1]), torch.tensor([1, 1, 2, 0]))), 4)
        0.1667
    """

    def compute(self) -> Tensor:
        tp, fp, _, fn = self._get_final_stats()
        return _precision_compute(tp, fp, fn, self.average, self.mdmc_reduce)


class Recall(_AveragedStatScores):
    """Recall: tp / (tp + fn).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Recall
        >>> recall = Recall(average='macro', num_classes=3, device="cpu")
        >>> round(float(recall(torch.tensor([2, 0, 2, 1]), torch.tensor([1, 1, 2, 0]))), 4)
        0.3333
    """

    def compute(self) -> Tensor:
        tp, fp, _, fn = self._get_final_stats()
        return _recall_compute(tp, fp, fn, self.average, self.mdmc_reduce)
