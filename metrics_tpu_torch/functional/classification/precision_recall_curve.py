"""Precision-recall curve: port of ``metrics_tpu/functional/classification/precision_recall_curve.py``.

The curve (a stable descending sort, then cumulative sums at the distinct
scores, sklearn's formulation) runs at epoch-end ``compute``, where the
data-dependent ``nonzero`` and its host sync are fine. For a fixed-shape,
constant-memory variant use the binned metrics
(:mod:`metrics_tpu_torch.classification.binned_precision_recall`).
"""
from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utilities.prints import rank_zero_warn


def _binary_clf_curve(
    preds: Tensor,
    target: Tensor,
    sample_weights: Optional[Sequence] = None,
    pos_label: int = 1,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Cumulative false and true positives at each distinct score, descending."""
    if sample_weights is not None and not isinstance(sample_weights, Tensor):
        sample_weights = torch.tensor(sample_weights, dtype=torch.float32, device=preds.device)

    if preds.ndim > target.ndim:
        preds = preds[:, 0]
    desc_score_indices = torch.argsort(-preds, stable=True)

    preds = preds[desc_score_indices]
    target = target[desc_score_indices]

    weight = sample_weights[desc_score_indices] if sample_weights is not None else 1.0

    # indices of distinct prediction values (ends of tied runs) and the curve's end
    distinct_value_indices = torch.nonzero(preds[1:] - preds[:-1], as_tuple=True)[0]
    end = torch.tensor([target.shape[0] - 1], dtype=distinct_value_indices.dtype, device=preds.device)
    threshold_idxs = torch.cat([distinct_value_indices, end])
    target = (target == pos_label).to(torch.int32)
    tps = torch.cumsum(target * weight, dim=0)[threshold_idxs]

    if sample_weights is not None:
        fps = torch.cumsum((1 - target) * weight, dim=0)[threshold_idxs]
    else:
        fps = 1 + threshold_idxs - tps

    return fps, tps, preds[threshold_idxs]


def _precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
) -> Tuple[Tensor, Tensor, int, Optional[int]]:
    """Canonicalise curve inputs to ``(N,)`` or ``(N, C)`` scores."""
    if preds.ndim == target.ndim:
        if pos_label is None:
            pos_label = 1
        if num_classes is not None and num_classes != 1:
            # multilabel problem
            if num_classes != preds.shape[1]:
                raise ValueError(
                    f"Argument `num_classes` was set to {num_classes} in"
                    f" metric `precision_recall_curve` but detected {preds.shape[1]}"
                    " number of classes from predictions"
                )
            preds = preds.transpose(0, 1).reshape(num_classes, -1).T
            target = target.transpose(0, 1).reshape(num_classes, -1).T
        else:
            preds = preds.reshape(-1)
            target = target.reshape(-1)
            num_classes = 1
    elif preds.ndim == target.ndim + 1:
        if pos_label is not None:
            rank_zero_warn(
                f"Argument `pos_label` should be `None` when running multiclass precision recall curve. Got {pos_label}"
            )
        if num_classes != preds.shape[1]:
            raise ValueError(
                f"Argument `num_classes` was set to {num_classes} in"
                f" metric `precision_recall_curve` but detected {preds.shape[1]}"
                " number of classes from predictions"
            )
        preds = preds.transpose(0, 1).reshape(num_classes, -1).T
        target = target.reshape(-1)
    else:
        raise ValueError("preds and target must have same number of dimensions, or one additional dimension for preds")

    return preds, target, num_classes, pos_label


def _precision_recall_curve_compute_single_class(
    preds: Tensor,
    target: Tensor,
    pos_label: int,
    sample_weights: Optional[Sequence] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """PR pairs for single-class inputs, recall decreasing, ending at ``(p=1, r=0)``."""
    fps, tps, thresholds = _binary_clf_curve(preds=preds, target=target, sample_weights=sample_weights, pos_label=pos_label)
    precision = tps / (tps + fps)
    recall = tps / tps[-1]

    # stop once full recall is attained, reverse so recall decreases
    last_ind = torch.nonzero(tps == tps[-1], as_tuple=True)[0][0]
    sl = slice(0, int(last_ind) + 1)

    precision = torch.cat([precision[sl].flip(0), torch.ones(1, dtype=precision.dtype, device=precision.device)])
    recall = torch.cat([recall[sl].flip(0), torch.zeros(1, dtype=recall.dtype, device=recall.device)])
    thresholds = thresholds[sl].flip(0)

    return precision, recall, thresholds


def _precision_recall_curve_compute_multi_class(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    sample_weights: Optional[Sequence] = None,
) -> Tuple[List[Tensor], List[Tensor], List[Tensor]]:
    """Per-class PR pairs, one class against the rest."""
    precision, recall, thresholds = [], [], []
    for cls in range(num_classes):
        preds_cls = preds[:, cls]
        prc_args = dict(preds=preds_cls, target=target, num_classes=1, pos_label=cls, sample_weights=sample_weights)
        if target.ndim > 1:
            prc_args.update(dict(target=target[:, cls], pos_label=1))
        res = precision_recall_curve(**prc_args)
        precision.append(res[0])
        recall.append(res[1])
        thresholds.append(res[2])
    return precision, recall, thresholds


def _precision_recall_curve_compute(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """Dispatch on the class count."""
    if num_classes == 1:
        if pos_label is None:
            pos_label = 1
        return _precision_recall_curve_compute_single_class(preds, target, pos_label, sample_weights)
    return _precision_recall_curve_compute_multi_class(preds, target, num_classes, sample_weights)


def precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """Precision-recall pairs at the distinct scores.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import precision_recall_curve
        >>> pred = torch.tensor([0.0, 1.0, 2.0, 3.0])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> precision, recall, thresholds = precision_recall_curve(pred, target, pos_label=1)
        >>> precision
        tensor([0.6667, 0.5000, 0.0000, 1.0000])
        >>> recall
        tensor([1.0000, 0.5000, 0.0000, 0.0000])
        >>> thresholds
        tensor([1., 2., 3.])
    """
    preds, target, num_classes, pos_label = _precision_recall_curve_update(preds, target, num_classes, pos_label)
    return _precision_recall_curve_compute(preds, target, num_classes, pos_label, sample_weights)
