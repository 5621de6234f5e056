"""Average precision: port of ``metrics_tpu/functional/classification/average_precision.py``."""
import warnings
from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    _precision_recall_curve_compute,
    _precision_recall_curve_update,
)
from metrics_tpu_torch.utilities.data import _bincount


def _average_precision_update(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
) -> Tuple[Tensor, Tensor, int, Optional[int]]:
    """Canonicalise AP inputs; ``micro`` flattens multilabel inputs to one class."""
    preds, target, num_classes, pos_label = _precision_recall_curve_update(preds, target, num_classes, pos_label)
    if average == "micro":
        if preds.ndim == target.ndim:
            preds = preds.reshape(-1)
            target = target.reshape(-1)
            num_classes = 1
        else:
            raise ValueError("Cannot use `micro` average with multi-class input")
    return preds, target, num_classes, pos_label


def _average_precision_compute(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    sample_weights: Optional[Sequence] = None,
) -> Union[List[Tensor], Tensor]:
    """AP from the PR curve."""
    precision, recall, _ = _precision_recall_curve_compute(preds, target, num_classes, pos_label)
    if average == "weighted":
        if preds.ndim == target.ndim and target.ndim > 1:
            weights = target.sum(dim=0).to(torch.float32)
        else:
            weights = _bincount(target, minlength=num_classes).to(torch.float32)
        weights = weights / torch.sum(weights)
    else:
        weights = None
    return _average_precision_compute_with_precision_recall(precision, recall, num_classes, average, weights)


def _average_precision_compute_with_precision_recall(
    precision: Union[Tensor, List[Tensor]],
    recall: Union[Tensor, List[Tensor]],
    num_classes: int,
    average: Optional[str] = "macro",
    weights: Optional[Tensor] = None,
) -> Union[List[Tensor], Tensor]:
    """Step-function integral of the PR curve. A class whose AP is NaN is left
    out of the macro and weighted averages, with a warning (one host sync)."""
    if num_classes == 1:
        return -torch.sum((recall[1:] - recall[:-1]) * precision[:-1])

    res = [-torch.sum((r[1:] - r[:-1]) * p[:-1]) for p, r in zip(precision, recall)]

    if average in ("macro", "weighted"):
        res_arr = torch.stack(res)
        if bool(torch.isnan(res_arr).any()):
            warnings.warn(
                "Average precision score for one or more classes was `nan`. Ignoring these classes in average",
                UserWarning,
            )
        nan_mask = torch.isnan(res_arr)
        if average == "macro":
            return torch.where(nan_mask, 0.0, res_arr).sum() / (~nan_mask).sum().clamp(min=1)
        weights = torch.ones_like(res_arr) if weights is None else weights
        return torch.where(nan_mask, 0.0, res_arr * weights).sum()
    if average is None:
        return res
    allowed_average = ("micro", "macro", "weighted", None)
    raise ValueError(f"Expected argument `average` to be one of {allowed_average} but got {average}")


def average_precision(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    sample_weights: Optional[Sequence] = None,
) -> Union[List[Tensor], Tensor]:
    """Average precision score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import average_precision
        >>> pred = torch.tensor([0.0, 1.0, 2.0, 3.0])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> float(average_precision(pred, target, pos_label=1))
        1.0
    """
    preds, target, num_classes, pos_label = _average_precision_update(preds, target, num_classes, pos_label, average)
    return _average_precision_compute(preds, target, num_classes, pos_label, average, sample_weights)
