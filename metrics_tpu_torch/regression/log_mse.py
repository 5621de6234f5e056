"""MeanSquaredLogError module metric: port of ``metrics_tpu/regression/log_mse.py``."""
from typing import Any

from torch import Tensor

from metrics_tpu_torch.functional.regression.log_mse import (
    _mean_squared_log_error_compute,
    _mean_squared_log_error_update,
)
from metrics_tpu_torch.metric import Metric


class MeanSquaredLogError(Metric):
    """MSLE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanSquaredLogError
        >>> target = torch.tensor([2.5, 5, 4, 8])
        >>> preds = torch.tensor([3.0, 5, 2.5, 7])
        >>> mean_squared_log_error = MeanSquaredLogError(device="cpu")
        >>> round(float(mean_squared_log_error(preds, target)), 4)
        0.0397
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_squared_log_error", 0.0, dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_log_error, n_obs = _mean_squared_log_error_update(preds, target)
        self.sum_squared_log_error = self.sum_squared_log_error + sum_squared_log_error
        self.total = self.total + n_obs

    def compute(self) -> Tensor:
        return _mean_squared_log_error_compute(self.sum_squared_log_error, self.total)
