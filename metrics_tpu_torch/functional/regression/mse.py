"""Mean squared error: port of ``metrics_tpu/functional/regression/mse.py``."""
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utilities.checks import _check_same_shape


def _mean_squared_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    diff = preds - target
    sum_squared_error = torch.sum(diff * diff)
    return sum_squared_error, target.numel()


def _mean_squared_error_compute(sum_squared_error: Tensor, n_obs: int, squared: bool = True) -> Tensor:
    mse = sum_squared_error / n_obs
    return mse if squared else torch.sqrt(mse)


def mean_squared_error(preds: Tensor, target: Tensor, squared: bool = True) -> Tensor:
    """MSE (or RMSE if ``squared=False``).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import mean_squared_error
        >>> x = torch.tensor([0.0, 1, 2, 3])
        >>> y = torch.tensor([0.0, 1, 2, 2])
        >>> float(mean_squared_error(x, y))
        0.25
    """
    sum_squared_error, n_obs = _mean_squared_error_update(preds, target)
    return _mean_squared_error_compute(sum_squared_error, n_obs, squared=squared)
