"""Precision and recall: port of ``metrics_tpu/functional/classification/precision_recall.py``.

The counts come from ``_stat_scores_update``, so a macro average of ``(B, C)``
scores runs the ``stat_scores`` kernel on the card.
"""
from typing import Optional, Tuple

from torch import Tensor

from metrics_tpu_torch.functional.classification.helpers import _mask_ignored
from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores, _stat_scores_update
from metrics_tpu_torch.utilities.enums import AverageMethod, MDMCAverageMethod


def _ratio_compute(
    numerator: Tensor,
    denominator: Tensor,
    tp: Tensor,
    fp: Tensor,
    fn: Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
) -> Tensor:
    """``numerator / denominator`` averaged as precision and recall average:
    classes with no tp, fp or fn leave a macro average, and stand as NaN
    under ``average="none"``."""
    numerator, denominator = numerator.float(), denominator.float()
    if average == AverageMethod.MACRO and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        numerator, denominator = _mask_ignored(numerator, denominator, tp + fp + fn == 0)

    if average == AverageMethod.NONE and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        numerator, denominator = _mask_ignored(numerator, denominator, (tp | fn | fp) == 0)

    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else (tp + fn).float(),
        average=average,
        mdmc_average=mdmc_average,
    )


def _precision_compute(
    tp: Tensor, fp: Tensor, fn: Tensor, average: Optional[str], mdmc_average: Optional[str]
) -> Tensor:
    """Precision = tp / (tp + fp) with averaging."""
    return _ratio_compute(tp, tp + fp, tp, fp, fn, average, mdmc_average)


def _recall_compute(
    tp: Tensor, fp: Tensor, fn: Tensor, average: Optional[str], mdmc_average: Optional[str]
) -> Tensor:
    """Recall = tp / (tp + fn) with averaging."""
    return _ratio_compute(tp, tp + fn, tp, fp, fn, average, mdmc_average)


def _check_avg_arguments(
    average: Optional[str], mdmc_average: Optional[str], num_classes: Optional[int], ignore_index: Optional[int]
) -> None:
    allowed_average = ("micro", "macro", "weighted", "samples", "none", None)
    if average not in allowed_average:
        raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")
    allowed_mdmc_average = (None, "samplewise", "global")
    if mdmc_average not in allowed_mdmc_average:
        raise ValueError(f"The `mdmc_average` has to be one of {allowed_mdmc_average}, got {mdmc_average}.")
    if average in ("macro", "weighted", "none", None) and (not num_classes or num_classes < 1):
        raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")
    if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")


def _precision_recall_update(
    preds: Tensor,
    target: Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
    ignore_index: Optional[int],
    num_classes: Optional[int],
    threshold: float,
    top_k: Optional[int],
    multiclass: Optional[bool],
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Check the averaging arguments, then count tp/fp/tn/fn."""
    _check_avg_arguments(average, mdmc_average, num_classes, ignore_index)
    return _stat_scores_update(
        preds,
        target,
        reduce="macro" if average in ("weighted", "none", None) else average,
        mdmc_reduce=mdmc_average,
        threshold=threshold,
        num_classes=num_classes,
        top_k=top_k,
        multiclass=multiclass,
        ignore_index=ignore_index,
    )


def precision(
    preds: Tensor,
    target: Tensor,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tensor:
    """Precision score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import precision
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> round(float(precision(preds, target, average='macro', num_classes=3)), 4)
        0.1667
    """
    tp, fp, _, fn = _precision_recall_update(
        preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass
    )
    return _precision_compute(tp, fp, fn, average, mdmc_average)


def recall(
    preds: Tensor,
    target: Tensor,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tensor:
    """Recall score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import recall
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> round(float(recall(preds, target, average='macro', num_classes=3)), 4)
        0.3333
    """
    tp, fp, _, fn = _precision_recall_update(
        preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass
    )
    return _recall_compute(tp, fp, fn, average, mdmc_average)


def precision_recall(
    preds: Tensor,
    target: Tensor,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tuple[Tensor, Tensor]:
    """Precision and recall from one stat-scores pass.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import precision_recall
        >>> p, r = precision_recall(torch.tensor([1, 0, 2, 1]), torch.tensor([1, 1, 2, 0]), num_classes=3, average='micro')
        >>> (float(p), float(r))
        (0.5, 0.5)
    """
    tp, fp, _, fn = _precision_recall_update(
        preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass
    )
    return (
        _precision_compute(tp, fp, fn, average, mdmc_average),
        _recall_compute(tp, fp, fn, average, mdmc_average),
    )
