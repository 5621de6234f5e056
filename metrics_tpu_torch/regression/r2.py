"""R2Score module metric: port of ``metrics_tpu/regression/r2.py``."""
from typing import Any

import torch
from torch import Tensor

from metrics_tpu_torch.functional.regression.r2 import _r2_score_compute, _r2_score_update
from metrics_tpu_torch.metric import Metric


class R2Score(Metric):
    """R2 (coefficient of determination), adjusted R2 included.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import R2Score
        >>> target = torch.tensor([3.0, -0.5, 2, 7])
        >>> preds = torch.tensor([2.5, 0.0, 2, 8])
        >>> r2score = R2Score(device="cpu")
        >>> round(float(r2score(preds, target)), 4)
        0.9486
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        num_outputs: int = 1,
        adjusted: int = 0,
        multioutput: str = "uniform_average",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_outputs = num_outputs
        if adjusted < 0 or not isinstance(adjusted, int):
            raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
        self.adjusted = adjusted
        allowed_multioutput = ("raw_values", "uniform_average", "variance_weighted")
        if multioutput not in allowed_multioutput:
            raise ValueError(
                f"Invalid input to argument `multioutput`. Choose one of the following: {allowed_multioutput}"
            )
        self.multioutput = multioutput

        self.add_state("sum_squared_error", torch.zeros(self.num_outputs), dist_reduce_fx="sum")
        self.add_state("sum_error", torch.zeros(self.num_outputs), dist_reduce_fx="sum")
        self.add_state("residual", torch.zeros(self.num_outputs), dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_obs, sum_obs, rss, n_obs = _r2_score_update(preds, target)
        self.sum_squared_error = self.sum_squared_error + sum_squared_obs
        self.sum_error = self.sum_error + sum_obs
        self.residual = self.residual + rss
        self.total = self.total + n_obs

    def compute(self) -> Tensor:
        return _r2_score_compute(
            self.sum_squared_error, self.sum_error, self.residual, self.total, self.adjusted, self.multioutput
        )
