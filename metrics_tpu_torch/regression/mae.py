"""MeanAbsoluteError module metric: port of ``metrics_tpu/regression/mae.py``."""
from typing import Any

from torch import Tensor

from metrics_tpu_torch.functional.regression.mae import _mean_absolute_error_compute, _mean_absolute_error_update
from metrics_tpu_torch.metric import Metric


class MeanAbsoluteError(Metric):
    """MAE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanAbsoluteError
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> mean_absolute_error = MeanAbsoluteError(device="cpu")
        >>> float(mean_absolute_error(preds, target))
        0.5
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_error", 0.0, dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_abs_error, n_obs = _mean_absolute_error_update(preds, target)
        self.sum_abs_error = self.sum_abs_error + sum_abs_error
        self.total = self.total + n_obs

    def compute(self) -> Tensor:
        return _mean_absolute_error_compute(self.sum_abs_error, self.total)
