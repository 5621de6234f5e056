"""Cohen's kappa: port of ``metrics_tpu/functional/classification/cohen_kappa.py``."""
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _confusion_matrix_compute,
    _confusion_matrix_update,
)

_cohen_kappa_update = _confusion_matrix_update


def _cohen_kappa_compute(confmat: Tensor, weights: Optional[str] = None) -> Tensor:
    """Cohen's kappa from a confusion matrix, unweighted (``None`` or
    ``"none"``), or with ``"linear"`` or ``"quadratic"`` disagreement weights."""
    confmat = _confusion_matrix_compute(confmat).to(torch.float32)
    n_classes = confmat.shape[0]
    sum0 = confmat.sum(dim=0, keepdim=True)
    sum1 = confmat.sum(dim=1, keepdim=True)
    expected = sum1 @ sum0 / sum0.sum()  # outer product of the marginals

    if weights is None or weights == "none":
        w_mat = 1.0 - torch.eye(n_classes, dtype=confmat.dtype, device=confmat.device)
    elif weights in ("linear", "quadratic"):
        idx = torch.arange(n_classes, dtype=confmat.dtype, device=confmat.device)
        diff = idx[:, None] - idx[None, :]
        w_mat = diff.abs() if weights == "linear" else diff**2
    else:
        raise ValueError(f"Received {weights} for argument ``weights`` but should be either None, 'linear' or 'quadratic'")

    k = torch.sum(w_mat * confmat) / torch.sum(w_mat * expected)
    return 1 - k


def cohen_kappa(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    weights: Optional[str] = None,
    threshold: float = 0.5,
) -> Tensor:
    """Cohen's kappa score: agreement between two labellings beyond chance.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import cohen_kappa
        >>> float(cohen_kappa(torch.tensor([0, 1, 0, 0]), torch.tensor([1, 1, 0, 0]), num_classes=2))
        0.5
    """
    confmat = _cohen_kappa_update(preds, target, num_classes, threshold)
    return _cohen_kappa_compute(confmat, weights)
