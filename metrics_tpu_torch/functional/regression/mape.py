"""Mean absolute percentage error: port of ``metrics_tpu/functional/regression/mape.py``."""
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utilities.checks import _check_same_shape


def _mean_absolute_percentage_error_update(
    preds: Tensor, target: Tensor, epsilon: float = 1.17e-06
) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    abs_per_error = torch.abs(preds - target) / torch.clamp(torch.abs(target), min=epsilon)
    return torch.sum(abs_per_error), target.numel()


def _mean_absolute_percentage_error_compute(sum_abs_per_error: Tensor, num_obs: int) -> Tensor:
    return sum_abs_per_error / num_obs


def mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """MAPE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import mean_absolute_percentage_error
        >>> target = torch.tensor([1.0, 10, 1e6])
        >>> preds = torch.tensor([0.9, 15, 1.2e6])
        >>> round(float(mean_absolute_percentage_error(preds, target)), 4)
        0.2667
    """
    sum_abs_per_error, num_obs = _mean_absolute_percentage_error_update(preds, target)
    return _mean_absolute_percentage_error_compute(sum_abs_per_error, num_obs)
