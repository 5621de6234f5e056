"""Cosine similarity: port of ``metrics_tpu/functional/regression/cosine_similarity.py``."""
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utilities.checks import _check_same_shape


def _cosine_similarity_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    return preds.to(torch.float32), target.to(torch.float32)


def _cosine_similarity_compute(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    dot_product = (preds * target).sum(dim=-1)
    preds_norm = torch.linalg.norm(preds, dim=-1)
    target_norm = torch.linalg.norm(target, dim=-1)
    similarity = dot_product / (preds_norm * target_norm)
    reduction_mapping = {
        "sum": torch.sum,
        "mean": torch.mean,
        "none": lambda x: x,
        None: lambda x: x,
    }
    return reduction_mapping[reduction](similarity)


def cosine_similarity(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    """Cosine similarity between rows of preds and target.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import cosine_similarity
        >>> target = torch.tensor([[1.0, 2, 3, 4], [1, 2, 3, 4]])
        >>> preds = torch.tensor([[1.0, 2, 3, 4], [-1, -2, -3, -4]])
        >>> [round(float(x), 4) for x in cosine_similarity(preds, target, 'none')]
        [1.0, -1.0]
    """
    preds, target = _cosine_similarity_update(preds, target)
    return _cosine_similarity_compute(preds, target, reduction)
