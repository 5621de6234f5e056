"""Small shared helpers for classification computes (port of
``metrics_tpu/functional/classification/helpers.py``)."""
import torch
from torch import Tensor


def _safe_divide(num: Tensor, denom: Tensor) -> Tensor:
    """Division with 0/0 -> 0."""
    denom = torch.where(denom == 0.0, 1.0, denom)
    return num / denom


def _mask_ignored(num: Tensor, denom: Tensor, cond: Tensor):
    """Mark entries where ``cond`` holds as ignored (-1): ``_reduce_stat_scores``
    gives negative denominators zero weight, the same as removing them from a
    macro average."""
    return torch.where(cond, -1.0, num), torch.where(cond, -1.0, denom)
