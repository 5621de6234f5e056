"""Mean absolute error: port of ``metrics_tpu/functional/regression/mae.py``."""
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utilities.checks import _check_same_shape


def _mean_absolute_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    preds = preds if preds.is_floating_point() else preds.to(torch.float32)
    target = target if target.is_floating_point() else target.to(torch.float32)
    sum_abs_error = torch.sum(torch.abs(preds - target))
    return sum_abs_error, target.numel()


def _mean_absolute_error_compute(sum_abs_error: Tensor, n_obs: int) -> Tensor:
    return sum_abs_error / n_obs


def mean_absolute_error(preds: Tensor, target: Tensor) -> Tensor:
    """MAE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import mean_absolute_error
        >>> x = torch.tensor([0.0, 1, 2, 3])
        >>> y = torch.tensor([0.0, 1, 2, 1])
        >>> float(mean_absolute_error(x, y))
        0.5
    """
    sum_abs_error, n_obs = _mean_absolute_error_update(preds, target)
    return _mean_absolute_error_compute(sum_abs_error, n_obs)
