"""Mean squared log error: port of ``metrics_tpu/functional/regression/log_mse.py``."""
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utilities.checks import _check_same_shape


def _mean_squared_log_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    sum_squared_log_error = torch.sum(torch.square(torch.log1p(preds) - torch.log1p(target)))
    return sum_squared_log_error, target.numel()


def _mean_squared_log_error_compute(sum_squared_log_error: Tensor, n_obs: int) -> Tensor:
    return sum_squared_log_error / n_obs


def mean_squared_log_error(preds: Tensor, target: Tensor) -> Tensor:
    """MSLE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import mean_squared_log_error
        >>> x = torch.tensor([0.0, 1, 2, 3])
        >>> y = torch.tensor([0.0, 1, 2, 2])
        >>> round(float(mean_squared_log_error(x, y)), 4)
        0.0207
    """
    sum_squared_log_error, n_obs = _mean_squared_log_error_update(preds, target)
    return _mean_squared_log_error_compute(sum_squared_log_error, n_obs)
