"""SDR and SI-SDR module metrics: port of ``metrics_tpu/audio/sdr.py``.

The states are the JAX package's: a float32 sum and an int32 count.
"""
from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.functional.audio.sdr import scale_invariant_signal_distortion_ratio, signal_distortion_ratio
from metrics_tpu_torch.metric import Metric


class SignalDistortionRatio(Metric):
    """Average SDR over samples.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SignalDistortionRatio
        >>> g = torch.Generator().manual_seed(0)
        >>> preds, target = torch.randn(8000, generator=g), torch.randn(8000, generator=g)
        >>> sdr = SignalDistortionRatio(device="cpu")
        >>> float(sdr(preds, target)) < 0
        True
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        use_cg_iter: Optional[int] = None,
        filter_length: int = 512,
        zero_mean: bool = False,
        load_diag: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.use_cg_iter = use_cg_iter
        self.filter_length = filter_length
        self.zero_mean = zero_mean
        self.load_diag = load_diag
        self.add_state("sum_sdr", 0.0, dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sdr_batch = signal_distortion_ratio(
            preds, target, self.use_cg_iter, self.filter_length, self.zero_mean, self.load_diag
        )
        self.sum_sdr = self.sum_sdr + sdr_batch.sum().to(self.sum_sdr.dtype)
        self.total = self.total + sdr_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_sdr / self.total


class ScaleInvariantSignalDistortionRatio(Metric):
    """Average SI-SDR over samples.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ScaleInvariantSignalDistortionRatio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> si_sdr = ScaleInvariantSignalDistortionRatio(device="cpu")
        >>> round(float(si_sdr(preds, target)), 2)
        18.4
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean
        self.add_state("sum_si_sdr", 0.0, dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        si_sdr_batch = scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=self.zero_mean)
        self.sum_si_sdr = self.sum_si_sdr + si_sdr_batch.sum().to(self.sum_si_sdr.dtype)
        self.total = self.total + si_sdr_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_si_sdr / self.total
