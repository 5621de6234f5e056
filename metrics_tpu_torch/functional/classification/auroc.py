"""Area under the ROC curve: port of ``metrics_tpu/functional/classification/auroc.py``.

Binary, multiclass (one class against the rest) and multilabel inputs;
``micro``, ``macro``, ``weighted`` and ``none`` averages; ``max_fpr`` gives
the partial area with the McClish correction. The curves are built a class
at a time (:func:`~metrics_tpu_torch.functional.classification.roc.roc`),
as in the JAX package: three host reads a class, so a compute at
C = 1,000 makes about 3,000.
"""
import warnings
from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.auc import _auc_compute_without_check
from metrics_tpu_torch.functional.classification.roc import roc
from metrics_tpu_torch.utilities.checks import _input_format_classification
from metrics_tpu_torch.utilities.data import _bincount, to_onehot
from metrics_tpu_torch.utilities.enums import AverageMethod, DataType


def _auroc_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, DataType]:
    """Check the inputs, find their mode, and flatten the extra dims of
    multidim multiclass and multilabel inputs into rows."""
    _, _, mode = _input_format_classification(preds, target)

    if mode == DataType.MULTIDIM_MULTICLASS and preds.ndim == target.ndim + 1:
        n_classes = preds.shape[1]
        preds = preds.transpose(0, 1).reshape(n_classes, -1).T
        target = target.reshape(-1)
    if mode == DataType.MULTILABEL and preds.ndim > 2:
        n_classes = preds.shape[1]
        preds = preds.transpose(0, 1).reshape(n_classes, -1).T
        target = target.transpose(0, 1).reshape(n_classes, -1).T

    return preds, target, mode


def _partial_auc(fpr: Tensor, tpr: Tensor, max_fpr: float) -> Tensor:
    """The area over ``[0, max_fpr]``, the curve cut by a linear
    interpolation at ``max_fpr``, with the McClish correction. An index past
    the curve's end reads its last point, as JAX's gather clamps it (a curve
    with no negative, all of whose rates are 0, gives NaN in both packages)."""
    max_area = torch.tensor(max_fpr, dtype=fpr.dtype, device=fpr.device)
    stop = int(torch.searchsorted(fpr, max_area.reshape(1), right=True)[0])
    lo, hi = stop - 1, min(stop, fpr.shape[0] - 1)
    weight = (max_area - fpr[lo]) / (fpr[hi] - fpr[lo])
    interp_tpr = tpr[lo] + weight * (tpr[hi] - tpr[lo])
    tpr = torch.cat([tpr[:stop], interp_tpr.reshape(1)])
    fpr = torch.cat([fpr[:stop], max_area.reshape(1)])

    partial_auc = _auc_compute_without_check(fpr, tpr, 1.0)
    min_area = 0.5 * max_area**2
    return 0.5 * (1 + (partial_auc - min_area) / (max_area - min_area))


def _auroc_compute(
    preds: Tensor,
    target: Tensor,
    mode: DataType,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    sample_weights: Optional[Sequence] = None,
) -> Tensor:
    """AUROC with the given average, or the partial AUC of binary inputs."""
    if mode == DataType.BINARY:
        num_classes = 1

    if max_fpr is not None:
        if not isinstance(max_fpr, float) or not 0 < max_fpr <= 1:
            raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")
        if mode != DataType.BINARY:
            raise ValueError(
                "Partial AUC computation not available in multilabel/multiclass setting,"
                f" 'max_fpr' must be set to `None`, received `{max_fpr}`."
            )

    if mode == DataType.MULTILABEL:
        if average == AverageMethod.MICRO:
            fpr, tpr, _ = roc(preds.reshape(-1), target.reshape(-1), 1, pos_label, sample_weights)
        elif num_classes:
            output = [
                roc(preds[:, i], target[:, i], num_classes=1, pos_label=1, sample_weights=sample_weights)
                for i in range(num_classes)
            ]
            fpr = [o[0] for o in output]
            tpr = [o[1] for o in output]
        else:
            raise ValueError("Detected input to be `multilabel` but you did not provide `num_classes` argument")
    else:
        if mode != DataType.BINARY:
            if num_classes is None:
                raise ValueError("Detected input to `multiclass` but you did not provide `num_classes` argument")
            if average == AverageMethod.WEIGHTED and torch.unique(target).numel() < num_classes:
                # a class with no observation is left out (its weight would be 0)
                target_bool_mat = to_onehot(target.reshape(-1), num_classes) == 1
                class_observed = (target_bool_mat.sum(dim=0) > 0).cpu()
                for c in range(num_classes):
                    if not class_observed[c]:
                        warnings.warn(f"Class {c} had 0 observations, omitted from AUROC calculation", UserWarning)
                observed = class_observed.to(preds.device)
                preds = preds[:, observed]
                target_bool_mat = target_bool_mat[:, observed]
                target = torch.nonzero(target_bool_mat, as_tuple=True)[1]
                num_classes = int(class_observed.sum())
                if num_classes == 1:
                    raise ValueError("Found 1 non-empty class in `multiclass` AUROC calculation")
        fpr, tpr, _ = roc(preds, target, num_classes, pos_label, sample_weights)

    if max_fpr is None or max_fpr == 1:
        if mode == DataType.MULTILABEL and average == AverageMethod.MICRO:
            pass
        elif num_classes != 1:
            auc_scores = [_auc_compute_without_check(x, y, 1.0) for x, y in zip(fpr, tpr)]
            if average == AverageMethod.NONE:
                return torch.stack(auc_scores)
            if average == AverageMethod.MACRO:
                return torch.mean(torch.stack(auc_scores))
            if average == AverageMethod.WEIGHTED:
                if mode == DataType.MULTILABEL:
                    support = torch.sum(target, dim=0)
                else:
                    support = _bincount(target.reshape(-1), minlength=num_classes)
                return torch.sum(torch.stack(auc_scores) * support / support.sum())
            allowed_average = (AverageMethod.NONE.value, AverageMethod.MACRO.value, AverageMethod.WEIGHTED.value)
            raise ValueError(f"Argument `average` expected to be one of the following: {allowed_average} but got {average}")
        return _auc_compute_without_check(fpr, tpr, 1.0)

    return _partial_auc(fpr, tpr, max_fpr)


def auroc(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    sample_weights: Optional[Sequence] = None,
) -> Tensor:
    """Area under the receiver operating characteristic curve.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import auroc
        >>> preds = torch.tensor([0.13, 0.26, 0.08, 0.19, 0.34])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> float(auroc(preds, target, pos_label=1))
        0.5
    """
    preds, target, mode = _auroc_update(preds, target)
    return _auroc_compute(preds, target, mode, num_classes, pos_label, average, max_fpr, sample_weights)
