"""Spearman rank correlation: port of ``metrics_tpu/functional/regression/spearman.py``.

Ranks come from one stable sort and a mean of the ranks of each run of
equal values, as in the JAX package (``spearman.py:17-33``), and are meant
to be its bits:

* the base ranks are ``float32(i) + 1``, which is what
  ``jnp.arange(1, n + 1, dtype=float32)`` gives; ``torch.arange(1, n + 1,
  dtype=torch.float32)`` differs from index 16,777,218 (``2**24 + 2``) on;
* the sort is stable: equal values, ``-0.0`` and ``0.0`` among them, keep
  their input order, and NaN sorts last, as ``jnp.argsort`` does; a NaN
  never equals its neighbour, so each NaN is a group of its own;
* a group's rank sum is a float32 scatter-add in sorted order. On the CPU
  it adds in that order, as the JAX package's ``segment_sum`` does; on the
  card in any order, which gives the same bits while a group's rank sum is
  exact in float32, below ``2**24`` (a tie group of up to 5,792 values from
  rank 1, fewer higher up), and may round it otherwise past that.
"""
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.data import dtype_name


def _rank_data(data: Tensor) -> Tensor:
    """Ranks (1-based) with ties assigned the mean of their ranks."""
    n = data.numel()
    idx = torch.argsort(data, stable=True)
    sorted_x = data[idx]
    base_rank = torch.arange(n, dtype=torch.float32, device=data.device) + 1

    # group ids for runs of equal values in sorted order
    starts = torch.ones(n, dtype=torch.bool, device=data.device)
    starts[1:] = sorted_x[1:] != sorted_x[:-1]
    group_id = torch.cumsum(starts, dim=0) - 1

    sums = torch.zeros(n, dtype=torch.float32, device=data.device).index_add_(0, group_id, base_rank)
    counts = torch.zeros(n, dtype=torch.float32, device=data.device).index_add_(0, group_id, torch.ones_like(base_rank))
    avg = sums / torch.clamp(counts, min=1.0)

    ranks_sorted = avg[group_id]
    return torch.zeros(n, dtype=torch.float32, device=data.device).index_copy_(0, idx, ranks_sorted)


def _spearman_corrcoef_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Validate the inputs and squeeze them to one dimension."""
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {dtype_name(preds.dtype)} and target: {dtype_name(target.dtype)}."
        )
    _check_same_shape(preds, target)
    preds = torch.squeeze(preds)
    target = torch.squeeze(target)
    if preds.ndim > 1 or target.ndim > 1:
        raise ValueError("Expected both predictions and target to be 1 dimensional tensors.")
    return preds, target


def _spearman_corrcoef_compute(preds: Tensor, target: Tensor, eps: float = 1e-6) -> Tensor:
    """Pearson correlation of the ranks."""
    preds = _rank_data(preds)
    target = _rank_data(target)

    preds_diff = preds - preds.mean()
    target_diff = target - target.mean()

    cov = (preds_diff * target_diff).mean()
    preds_std = torch.sqrt((preds_diff * preds_diff).mean())
    target_std = torch.sqrt((target_diff * target_diff).mean())

    corrcoef = cov / (preds_std * target_std + eps)
    return torch.clamp(corrcoef, -1.0, 1.0)


def spearman_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Spearman's rank correlation coefficient.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import spearman_corrcoef
        >>> target = torch.tensor([3.0, -0.5, 2, 7])
        >>> preds = torch.tensor([2.5, 0.0, 2, 8])
        >>> round(float(spearman_corrcoef(preds, target)), 4)
        1.0
    """
    preds, target = _spearman_corrcoef_update(preds, target)
    return _spearman_corrcoef_compute(preds, target)
