"""The one-hot route of multi-class inputs, as the confusion-matrix and
stat-score families counted them before they counted from class labels.

Plain functions of the port's own helpers (no JAX), so that a CPU test and a
card test can hold the label route against the same counts.
"""
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.stat_scores import _del_column, _stat_scores
from metrics_tpu_torch.ops import confusion_matrix_counts
from metrics_tpu_torch.utilities.checks import _input_format_classification


def onehot_stat_scores(
    preds: Tensor,
    target: Tensor,
    reduce: str,
    num_classes: Optional[int] = None,
    ignore_index: Optional[int] = None,
    sample_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """tp/fp/tn/fn through int32 one-hots, ``mdmc_reduce="global"``; a
    non-negative ``ignore_index`` deletes its column (micro) or marks it -1
    (macro), a per-sample ``sample_mask`` covers its sample's positions."""
    preds, target, _ = _input_format_classification(
        preds, target, num_classes=num_classes, ignore_index=ignore_index
    )
    if preds.ndim == 3:
        if sample_mask is not None:
            sample_mask = torch.repeat_interleave(sample_mask, preds.shape[2])
        preds = preds.transpose(1, 2).reshape(-1, preds.shape[1])
        target = target.transpose(1, 2).reshape(-1, target.shape[1])
    if ignore_index is not None and reduce != "macro":
        preds, target = _del_column(preds, ignore_index), _del_column(target, ignore_index)
    counts = _stat_scores(preds, target, reduce=reduce, sample_mask=sample_mask)
    if ignore_index is not None and reduce == "macro":
        for t in counts:
            t[..., ignore_index] = -1
    return counts


def onehot_confmat(preds: Tensor, target: Tensor, num_classes: int) -> Tensor:
    """The confusion matrix of the argmax of each side's one-hots."""
    labels = not preds.is_floating_point()
    preds, target, _ = _input_format_classification(preds, target, num_classes=num_classes if labels else None)
    target_cls = target.argmax(dim=1).reshape(-1).to(torch.int32)
    pred_cls = preds.argmax(dim=1).reshape(-1).to(torch.int32)
    return confusion_matrix_counts(target_cls, pred_cls, num_classes)
