"""ShortTimeObjectiveIntelligibility: port of ``metrics_tpu/audio/stoi.py``.

The measure runs batched on the metric's device
(:mod:`metrics_tpu_torch.functional.audio.stoi`); the states are the JAX
package's: a float32 sum and an int32 count.
"""
from typing import Any

from torch import Tensor

from metrics_tpu_torch.functional.audio.stoi import short_time_objective_intelligibility
from metrics_tpu_torch.metric import Metric


class ShortTimeObjectiveIntelligibility(Metric):
    """STOI (standard or extended) averaged over samples.

    Args:
        fs: sampling frequency of the inputs (Hz)
        extended: the extended STOI (Jensen & Taal 2016)

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ShortTimeObjectiveIntelligibility
        >>> g = torch.Generator().manual_seed(42)
        >>> preds, target = torch.randn(8000, generator=g), torch.randn(8000, generator=g)
        >>> stoi = ShortTimeObjectiveIntelligibility(8000, device="cpu")
        >>> bool(stoi(preds, target) < 0.1)
        True
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, fs: int, extended: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.fs = fs
        self.extended = extended
        self.add_state("sum_stoi", 0.0, dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        vals = short_time_objective_intelligibility(preds, target, self.fs, self.extended)
        self.sum_stoi = self.sum_stoi + vals.sum()
        self.total = self.total + vals.numel()

    def compute(self) -> Tensor:
        return self.sum_stoi / self.total
