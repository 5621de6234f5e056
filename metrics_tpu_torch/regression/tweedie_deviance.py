"""TweedieDevianceScore module metric: port of ``metrics_tpu/regression/tweedie_deviance.py``.

An eager update checks the inputs' values against ``power`` (host reads);
an engine's update skips them, as ``jax.jit`` does in the JAX package.
"""
from typing import Any

from torch import Tensor

from metrics_tpu_torch.functional.regression.tweedie_deviance import (
    _tweedie_deviance_score_compute,
    _tweedie_deviance_score_update,
)
from metrics_tpu_torch.metric import Metric


class TweedieDevianceScore(Metric):
    """Tweedie deviance score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import TweedieDevianceScore
        >>> targets = torch.tensor([1.0, 2.0, 3.0, 4.0])
        >>> preds = torch.tensor([4.0, 3.0, 2.0, 1.0])
        >>> deviance_score = TweedieDevianceScore(power=2, device="cpu")
        >>> round(float(deviance_score(preds, targets)), 4)
        1.2083
    """

    is_differentiable = True
    higher_is_better = None
    full_state_update = False

    def __init__(self, power: float = 0.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if 0 < power < 1:
            raise ValueError(f"Deviance Score is not defined for power={power}.")
        self.power = power
        self.add_state("sum_deviance_score", 0.0, dist_reduce_fx="sum")
        self.add_state("num_observations", 0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, targets: Tensor) -> None:
        sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, self.power)
        self.sum_deviance_score = self.sum_deviance_score + sum_deviance_score
        self.num_observations = self.num_observations + num_observations

    def compute(self) -> Tensor:
        return _tweedie_deviance_score_compute(self.sum_deviance_score, self.num_observations)
