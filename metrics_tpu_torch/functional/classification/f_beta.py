"""F-beta and F1: port of ``metrics_tpu/functional/classification/f_beta.py``.

The masking follows the JAX file: classes with no tp, fp or fn and the
``ignore_index`` column stand as NaN under ``average="none"``; a macro
average leaves out classes whose tp + fp + fn is 0 or -3 (the column that
``_stat_scores_update`` marks -1 for ``ignore_index``).
"""
import numbers
from typing import Optional

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.helpers import _safe_divide
from metrics_tpu_torch.functional.classification.precision_recall import _precision_recall_update
from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores
from metrics_tpu_torch.utilities.enums import AverageMethod, MDMCAverageMethod


def _fbeta_compute(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    beta: float,
    ignore_index: Optional[int],
    average: Optional[str],
    mdmc_average: Optional[str],
) -> Tensor:
    """F-beta from stat scores."""
    if average == AverageMethod.MICRO and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        mask = tp >= 0
        tp_s = torch.where(mask, tp, 0).sum().float()
        fp_s = torch.where(mask, fp, 0).sum().float()
        fn_s = torch.where(mask, fn, 0).sum().float()
        precision = _safe_divide(tp_s, tp_s + fp_s)
        recall = _safe_divide(tp_s, tp_s + fn_s)
    else:
        precision = _safe_divide(tp.float(), (tp + fp).float())
        recall = _safe_divide(tp.float(), (tp + fn).float())

    num = (1 + beta**2) * precision * recall
    denom = beta**2 * precision + recall
    denom = torch.where(denom == 0.0, 1.0, denom)  # avoid division by 0

    # classes absent from preds and target are meaningless: mark them ignored
    if average == AverageMethod.NONE and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        cond = (tp | fn | fp) == 0
        if ignore_index is not None:
            cond = cond | (torch.arange(cond.shape[-1], device=cond.device) == ignore_index)
        num = torch.where(cond, -1.0, num)
        denom = torch.where(cond, -1.0, denom)
    elif ignore_index is not None and average not in (AverageMethod.MICRO, AverageMethod.SAMPLES):
        num, denom = num.clone(), denom.clone()
        if mdmc_average == MDMCAverageMethod.SAMPLEWISE:
            num[..., ignore_index] = -1.0
            denom[..., ignore_index] = -1.0
        else:
            num[ignore_index, ...] = -1.0
            denom[ignore_index, ...] = -1.0

    if average == AverageMethod.MACRO and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        cond = (tp + fp + fn == 0) | (tp + fp + fn == -3)
        num = torch.where(cond, -1.0, num)
        denom = torch.where(cond, -1.0, denom)

    return _reduce_stat_scores(
        numerator=num,
        denominator=denom,
        weights=None if average != AverageMethod.WEIGHTED else (tp + fn).float(),
        average=average,
        mdmc_average=mdmc_average,
    )


def fbeta_score(
    preds: Tensor,
    target: Tensor,
    beta: float = 1.0,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tensor:
    """F-beta score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import fbeta_score
        >>> target = torch.tensor([0, 1, 2, 0, 1, 2])
        >>> preds = torch.tensor([0, 2, 1, 0, 0, 1])
        >>> round(float(fbeta_score(preds, target, beta=0.5)), 4)
        0.3333
    """
    tp, fp, tn, fn = _precision_recall_update(
        preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass
    )
    return _fbeta_compute(tp, fp, tn, fn, beta, ignore_index, average, mdmc_average)


def f1_score(
    preds: Tensor,
    target: Tensor,
    beta: float = 1.0,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tensor:
    """F1 score: F-beta with beta = 1.

    ``beta`` holds its positional slot, as in the JAX package, and is
    ignored; a value that is not a number (e.g. ``f1_score(preds, target,
    "macro")``) raises instead of computing the micro average.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import f1_score
        >>> target = torch.tensor([0, 1, 2, 0, 1, 2])
        >>> preds = torch.tensor([0, 2, 1, 0, 0, 1])
        >>> round(float(f1_score(preds, target)), 4)
        0.3333
    """
    if isinstance(beta, bool) or not isinstance(beta, (numbers.Real, Tensor, np.ndarray)):
        raise ValueError(
            f"Expected argument `beta` to be a float but got {beta!r} — note `f1_score` ignores `beta`"
            f" (it is fixed to 1.0); pass `average`/`num_classes` by keyword"
        )
    return fbeta_score(preds, target, 1.0, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass)
