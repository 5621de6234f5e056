"""WeightedMeanAbsolutePercentageError module metric: port of ``metrics_tpu/regression/wmape.py``."""
from typing import Any

from torch import Tensor

from metrics_tpu_torch.functional.regression.wmape import (
    _weighted_mean_absolute_percentage_error_compute,
    _weighted_mean_absolute_percentage_error_update,
)
from metrics_tpu_torch.metric import Metric


class WeightedMeanAbsolutePercentageError(Metric):
    """WMAPE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import WeightedMeanAbsolutePercentageError
        >>> m = WeightedMeanAbsolutePercentageError(device="cpu")
        >>> m.update(torch.tensor([1.2, 2.5, 6.0]), torch.tensor([1.0, 3.0, 5.0]))
        >>> round(float(m.compute()), 4)
        0.1889
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_error", 0.0, dist_reduce_fx="sum")
        self.add_state("sum_scale", 0.0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_abs_error, sum_scale = _weighted_mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_error = self.sum_abs_error + sum_abs_error
        self.sum_scale = self.sum_scale + sum_scale

    def compute(self) -> Tensor:
        return _weighted_mean_absolute_percentage_error_compute(self.sum_abs_error, self.sum_scale)
