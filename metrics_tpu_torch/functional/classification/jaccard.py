"""Jaccard index (IoU): port of ``metrics_tpu/functional/classification/jaccard.py``."""
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.confusion_matrix import _confusion_matrix_update
from metrics_tpu_torch.utilities.distributed import reduce

_jaccard_update = _confusion_matrix_update


def _jaccard_from_confmat(
    confmat: Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
    absent_score: float = 0.0,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """Per-class intersection over union from a confusion matrix, reduced.

    A class in ``[0, C)`` named by ``ignore_index`` loses its target row
    before the scores and its score after; a class with an empty union
    scores ``absent_score``.
    """
    ignored = ignore_index is not None and 0 <= ignore_index < num_classes
    if ignored:
        confmat = confmat.clone()
        confmat[ignore_index] = 0

    intersection = torch.diag(confmat)
    union = confmat.sum(dim=0) + confmat.sum(dim=1) - intersection

    scores = intersection.to(torch.float32) / torch.where(union == 0, 1.0, union.to(torch.float32))
    scores = torch.where(union == 0, absent_score, scores)

    if ignored:
        scores = torch.cat([scores[:ignore_index], scores[ignore_index + 1 :]])

    return reduce(scores, reduction=reduction)


def jaccard_index(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
    absent_score: float = 0.0,
    threshold: float = 0.5,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """Jaccard index (intersection over union).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import jaccard_index
        >>> target = torch.tensor([[0, 1, 1], [1, 1, 0]])
        >>> pred = torch.tensor([[0, 1, 0], [1, 1, 1]])
        >>> round(float(jaccard_index(pred, target, num_classes=2)), 4)
        0.4667
    """
    confmat = _jaccard_update(preds, target, num_classes, threshold)
    return _jaccard_from_confmat(confmat, num_classes, ignore_index, absent_score, reduction)
