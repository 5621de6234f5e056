"""MeanAbsolutePercentageError module metric: port of ``metrics_tpu/regression/mape.py``.

Its ``total`` is a float32 state, as in the JAX package (``mape.py:36``).
"""
from typing import Any

from torch import Tensor

from metrics_tpu_torch.functional.regression.mape import (
    _mean_absolute_percentage_error_compute,
    _mean_absolute_percentage_error_update,
)
from metrics_tpu_torch.metric import Metric


class MeanAbsolutePercentageError(Metric):
    """MAPE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanAbsolutePercentageError
        >>> target = torch.tensor([1.0, 10, 1e6])
        >>> preds = torch.tensor([0.9, 15, 1.2e6])
        >>> mean_abs_percentage_error = MeanAbsolutePercentageError(device="cpu")
        >>> round(float(mean_abs_percentage_error(preds, target)), 4)
        0.2667
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_per_error", 0.0, dist_reduce_fx="sum")
        self.add_state("total", 0.0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_abs_per_error, num_obs = _mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_per_error = self.sum_abs_per_error + sum_abs_per_error
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        return _mean_absolute_percentage_error_compute(self.sum_abs_per_error, self.total)
