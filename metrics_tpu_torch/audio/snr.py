"""SNR and SI-SNR module metrics: port of ``metrics_tpu/audio/snr.py``.

The states are the JAX package's: a float32 sum and an int32 count.
"""
from typing import Any

from torch import Tensor

from metrics_tpu_torch.functional.audio.snr import scale_invariant_signal_noise_ratio, signal_noise_ratio
from metrics_tpu_torch.metric import Metric


class SignalNoiseRatio(Metric):
    """Average SNR over samples.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SignalNoiseRatio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> snr = SignalNoiseRatio(device="cpu")
        >>> round(float(snr(preds, target)), 4)
        16.1805
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean
        self.add_state("sum_snr", 0.0, dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        snr_batch = signal_noise_ratio(preds=preds, target=target, zero_mean=self.zero_mean)
        self.sum_snr = self.sum_snr + snr_batch.sum().to(self.sum_snr.dtype)
        self.total = self.total + snr_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_snr / self.total


class ScaleInvariantSignalNoiseRatio(Metric):
    """Average SI-SNR over samples.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ScaleInvariantSignalNoiseRatio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> si_snr = ScaleInvariantSignalNoiseRatio(device="cpu")
        >>> round(float(si_snr(preds, target)), 4)
        15.0918
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_si_snr", 0.0, dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        si_snr_batch = scale_invariant_signal_noise_ratio(preds=preds, target=target)
        self.sum_si_snr = self.sum_si_snr + si_snr_batch.sum().to(self.sum_si_snr.dtype)
        self.total = self.total + si_snr_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_si_snr / self.total
