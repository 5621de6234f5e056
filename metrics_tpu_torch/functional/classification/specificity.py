"""Specificity: port of ``metrics_tpu/functional/classification/specificity.py``."""
from typing import Optional

from torch import Tensor

from metrics_tpu_torch.functional.classification.helpers import _mask_ignored
from metrics_tpu_torch.functional.classification.precision_recall import _precision_recall_update
from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores
from metrics_tpu_torch.utilities.enums import AverageMethod, MDMCAverageMethod


def _specificity_compute(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
) -> Tensor:
    """Specificity = tn / (tn + fp) with averaging."""
    numerator = tn.float()
    denominator = (tn + fp).float()

    if average == AverageMethod.NONE and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        numerator, denominator = _mask_ignored(numerator, denominator, (tp | fn | fp) == 0)

    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else denominator,
        average=average,
        mdmc_average=mdmc_average,
    )


def specificity(
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
    """Specificity score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import specificity
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> round(float(specificity(preds, target, average='macro', num_classes=3)), 4)
        0.6111
    """
    tp, fp, tn, fn = _precision_recall_update(
        preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass
    )
    return _specificity_compute(tp, fp, tn, fn, average, mdmc_average)
