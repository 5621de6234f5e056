"""HammingDistance module metric: port of ``metrics_tpu/classification/hamming.py``."""
from typing import Any

from torch import Tensor

from metrics_tpu_torch.functional.classification.hamming import _hamming_distance_compute, _hamming_distance_update
from metrics_tpu_torch.metric import Metric


class HammingDistance(Metric):
    """Average Hamming distance (loss); ``correct`` and ``total`` are int32
    states, as in the JAX package.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import HammingDistance
        >>> hamming_distance = HammingDistance(device="cpu")
        >>> float(hamming_distance(torch.tensor([[0, 1], [0, 1]]), torch.tensor([[0, 1], [1, 1]])))
        0.25
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(self, threshold: float = 0.5, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("correct", default=0, dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")
        self.threshold = threshold

    def update(self, preds: Tensor, target: Tensor) -> None:
        correct, total = _hamming_distance_update(preds, target, self.threshold)
        self.correct = self.correct + correct
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _hamming_distance_compute(self.correct, self.total)
