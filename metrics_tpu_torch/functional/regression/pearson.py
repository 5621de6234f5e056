"""Pearson correlation: port of ``metrics_tpu/functional/regression/pearson.py``.

Streaming means, unnormalised variances and co-moment, updated batch by
batch with the JAX package's float32 formula; a module's states sync by one
gather (``dist_reduce_fx=None``) and merge in rank order
(:func:`metrics_tpu_torch.regression.pearson._final_aggregation`).
"""
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utilities.checks import _check_same_shape


def _pearson_corrcoef_update(
    preds: Tensor,
    target: Tensor,
    mean_x: Tensor,
    mean_y: Tensor,
    var_x: Tensor,
    var_y: Tensor,
    corr_xy: Tensor,
    n_prior: Tensor,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """One streaming-moment step."""
    _check_same_shape(preds, target)
    preds = torch.squeeze(preds)
    target = torch.squeeze(target)
    if preds.ndim > 1 or target.ndim > 1:
        raise ValueError("Expected both predictions and target to be 1 dimensional tensors.")
    # an integer input's mean is float32 in jnp; the differences below promote to float32 alike
    preds = preds if preds.is_floating_point() else preds.to(torch.float32)
    target = target if target.is_floating_point() else target.to(torch.float32)

    n_obs = preds.numel()
    mx_new = (n_prior * mean_x + preds.mean() * n_obs) / (n_prior + n_obs)
    my_new = (n_prior * mean_y + target.mean() * n_obs) / (n_prior + n_obs)
    n_prior = n_prior + n_obs
    var_x = var_x + ((preds - mx_new) * (preds - mean_x)).sum()
    var_y = var_y + ((target - my_new) * (target - mean_y)).sum()
    corr_xy = corr_xy + ((preds - mx_new) * (target - mean_y)).sum()

    return mx_new, my_new, var_x, var_y, corr_xy, n_prior


def _pearson_corrcoef_compute(var_x: Tensor, var_y: Tensor, corr_xy: Tensor, nb: Tensor) -> Tensor:
    """The correlation from the accumulated moments."""
    var_x = var_x / (nb - 1)
    var_y = var_y / (nb - 1)
    corr_xy = corr_xy / (nb - 1)
    corrcoef = torch.squeeze(corr_xy / torch.sqrt(var_x * var_y))
    return torch.clamp(corrcoef, -1.0, 1.0)


def pearson_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Pearson correlation coefficient.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pearson_corrcoef
        >>> target = torch.tensor([3.0, -0.5, 2, 7])
        >>> preds = torch.tensor([2.5, 0.0, 2, 8])
        >>> round(float(pearson_corrcoef(preds, target)), 4)
        0.9849
    """
    zero = torch.zeros(1, dtype=preds.dtype if preds.is_floating_point() else torch.float32, device=preds.device)
    _, _, var_x, var_y, corr_xy, nb = _pearson_corrcoef_update(preds, target, zero, zero, zero, zero, zero, zero)
    return _pearson_corrcoef_compute(var_x, var_y, corr_xy, nb)
