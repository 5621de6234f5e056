"""MeanSquaredError module metric: port of ``metrics_tpu/regression/mse.py``."""
from typing import Any

from torch import Tensor

from metrics_tpu_torch.functional.regression.mse import _mean_squared_error_compute, _mean_squared_error_update
from metrics_tpu_torch.metric import Metric


class MeanSquaredError(Metric):
    """MSE (or RMSE with ``squared=False``).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanSquaredError
        >>> target = torch.tensor([2.5, 5.0, 4.0, 8.0])
        >>> preds = torch.tensor([3.0, 5.0, 2.5, 7.0])
        >>> mean_squared_error = MeanSquaredError(device="cpu")
        >>> float(mean_squared_error(preds, target))
        0.875
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, squared: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_squared_error", 0.0, dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")
        self.squared = squared

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_error, n_obs = _mean_squared_error_update(preds, target)
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.total = self.total + n_obs

    def compute(self) -> Tensor:
        return _mean_squared_error_compute(self.sum_squared_error, self.total, squared=self.squared)
