"""ExplainedVariance module metric: port of ``metrics_tpu/regression/explained_variance.py``.

The states start as scalars and take the shape ``(D,)`` at the first update
on ``(N, D)`` inputs, as in the JAX package. Under ``jit_update=True`` that
first update changes the layout of the states, which a captured program
cannot hold: the engine declines it and the eager path serves every update
(``dispatch_stats["last_cause"] == "unsupported"``).
"""
from typing import Any

from torch import Tensor

from metrics_tpu_torch.functional.regression.explained_variance import (
    _explained_variance_compute,
    _explained_variance_update,
)
from metrics_tpu_torch.metric import Metric


class ExplainedVariance(Metric):
    """Explained variance from running sums of moments.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ExplainedVariance
        >>> target = torch.tensor([3.0, -0.5, 2, 7])
        >>> preds = torch.tensor([2.5, 0.0, 2, 8])
        >>> explained_variance = ExplainedVariance(device="cpu")
        >>> round(float(explained_variance(preds, target)), 4)
        0.9572
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, multioutput: str = "uniform_average", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        allowed_multioutput = ("raw_values", "uniform_average", "variance_weighted")
        if multioutput not in allowed_multioutput:
            raise ValueError(
                f"Invalid input to argument `multioutput`. Choose one of the following: {allowed_multioutput}"
            )
        self.multioutput = multioutput
        self.add_state("sum_error", 0.0, dist_reduce_fx="sum")
        self.add_state("sum_squared_error", 0.0, dist_reduce_fx="sum")
        self.add_state("sum_target", 0.0, dist_reduce_fx="sum")
        self.add_state("sum_squared_target", 0.0, dist_reduce_fx="sum")
        self.add_state("n_obs", 0.0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target = _explained_variance_update(preds, target)
        self.n_obs = self.n_obs + n_obs
        self.sum_error = self.sum_error + sum_error
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.sum_target = self.sum_target + sum_target
        self.sum_squared_target = self.sum_squared_target + sum_squared_target

    def compute(self) -> Tensor:
        return _explained_variance_compute(
            self.n_obs,
            self.sum_error,
            self.sum_squared_error,
            self.sum_target,
            self.sum_squared_target,
            self.multioutput,
        )
