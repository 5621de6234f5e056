"""Confusion matrix: port of ``metrics_tpu/functional/classification/confusion_matrix.py``.

Two update formulations give the same int32 counts: a bincount over
``target * C + pred`` (plain PyTorch, the default), and the one the JAX
package writes as a one-hot product, which here is the ``confusion_matrix``
kernel.
"""
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.ops import confusion_matrix_counts
from metrics_tpu_torch.utilities.checks import _input_format_classification, _is_floating, _is_traced
from metrics_tpu_torch.utilities.data import _bincount
from metrics_tpu_torch.utilities.enums import DataType
from metrics_tpu_torch.utilities.prints import rank_zero_warn


def _canonicalize_confmat_labels(preds: Tensor, target: Tensor, num_classes: int, threshold: float):
    """Input canonicalization shared by both update formulations.

    ``num_classes`` passes through only for integer-label inputs; float and
    binary layouts take the class count from the shape. Multiclass layouts
    come back as class indices (one-hot, then argmax, as in the JAX package).
    """
    nc = num_classes if (preds.ndim == target.ndim and not _is_floating(preds)) else None
    preds, target, mode = _input_format_classification(preds, target, threshold, num_classes=nc)
    if mode not in (DataType.BINARY, DataType.MULTILABEL):
        preds = preds.argmax(dim=1)
        target = target.argmax(dim=1)
    return preds, target


def _confusion_matrix_update(
    preds: Tensor, target: Tensor, num_classes: int, threshold: float = 0.5, multilabel: bool = False
) -> Tensor:
    """Confusion matrix of one batch by bincount."""
    preds, target = _canonicalize_confmat_labels(preds, target, num_classes, threshold)
    if multilabel:
        classes = torch.arange(num_classes, device=preds.device)
        unique_mapping = ((2 * target + preds) + 4 * classes).reshape(-1)
        minlength = 4 * num_classes
    else:
        unique_mapping = target.reshape(-1) * num_classes + preds.reshape(-1)
        minlength = num_classes**2

    bins = _bincount(unique_mapping, minlength=minlength)
    if multilabel:
        return bins.reshape(num_classes, 2, 2)
    return bins.reshape(num_classes, num_classes)


def _confusion_matrix_update_matmul(
    preds: Tensor, target: Tensor, num_classes: int, threshold: float = 0.5
) -> Tensor:
    """Confusion matrix of one batch by the ``confusion_matrix`` kernel
    (the same counts as :func:`_confusion_matrix_update`)."""
    preds, target = _canonicalize_confmat_labels(preds, target, num_classes, threshold)
    return confusion_matrix_counts(
        target.reshape(-1).to(torch.int32), preds.reshape(-1).to(torch.int32), num_classes
    )


def _confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    """Apply the normalization mode."""
    allowed_normalize = ("true", "pred", "all", "none", None)
    if normalize not in allowed_normalize:
        raise ValueError(f"Argument average needs to one of the following: {allowed_normalize}")
    if normalize is not None and normalize != "none":
        confmat = confmat.float()
        if normalize == "true":
            confmat = confmat / confmat.sum(dim=1, keepdim=True)
        elif normalize == "pred":
            confmat = confmat / confmat.sum(dim=0, keepdim=True)
        elif normalize == "all":
            confmat = confmat / confmat.sum()

        if not _is_traced():  # the count reads the device; an engine's program skips it, as under jax.jit
            nan_elements = int(torch.isnan(confmat).sum())
            if nan_elements:
                rank_zero_warn(f"{nan_elements} nan values found in confusion matrix have been replaced with zeros.")
        confmat = torch.where(torch.isnan(confmat), 0.0, confmat)
    return confmat


def confusion_matrix(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    normalize: Optional[str] = None,
    threshold: float = 0.5,
    multilabel: bool = False,
) -> Tensor:
    """Confusion matrix.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import confusion_matrix
        >>> confusion_matrix(torch.tensor([0, 1, 0, 0]), torch.tensor([1, 1, 0, 0]), num_classes=2)
        tensor([[2, 0],
                [1, 1]], dtype=torch.int32)
    """
    confmat = _confusion_matrix_update(preds, target, num_classes, threshold, multilabel)
    return _confusion_matrix_compute(confmat, normalize)
