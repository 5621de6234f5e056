"""Weighted MAPE: port of ``metrics_tpu/functional/regression/wmape.py``."""
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utilities.checks import _check_same_shape


def _weighted_mean_absolute_percentage_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    sum_abs_error = torch.abs(preds - target).sum()
    sum_scale = torch.abs(target).sum()
    return sum_abs_error, sum_scale


def _weighted_mean_absolute_percentage_error_compute(
    sum_abs_error: Tensor, sum_scale: Tensor, epsilon: float = 1.17e-06
) -> Tensor:
    return sum_abs_error / torch.clamp(sum_scale, min=epsilon)


def weighted_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """WMAPE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import weighted_mean_absolute_percentage_error
        >>> preds = torch.tensor([1.0, 2.0])
        >>> target = torch.tensor([1.0, 1.0])
        >>> float(weighted_mean_absolute_percentage_error(preds, target))
        0.5
    """
    sum_abs_error, sum_scale = _weighted_mean_absolute_percentage_error_update(preds, target)
    return _weighted_mean_absolute_percentage_error_compute(sum_abs_error, sum_scale)
