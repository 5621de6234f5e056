"""SNR and SI-SNR: port of ``metrics_tpu/functional/audio/snr.py``.

Reductions over the trailing time axis; ``eps`` is the input dtype's
machine epsilon, as in the JAX package.
"""
import torch
from torch import Tensor

from metrics_tpu_torch.functional.audio.sdr import scale_invariant_signal_distortion_ratio
from metrics_tpu_torch.utilities.checks import _check_same_shape


def signal_noise_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """SNR in dB over the trailing time axis.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import signal_noise_ratio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(signal_noise_ratio(preds, target)), 4)
        16.1805
    """
    _check_same_shape(preds, target)
    eps = torch.finfo(preds.dtype).eps

    if zero_mean:
        target = target - target.mean(dim=-1, keepdim=True)
        preds = preds - preds.mean(dim=-1, keepdim=True)

    noise = target - preds
    snr_value = ((target**2).sum(dim=-1) + eps) / ((noise**2).sum(dim=-1) + eps)
    return 10 * torch.log10(snr_value)


def scale_invariant_signal_noise_ratio(preds: Tensor, target: Tensor) -> Tensor:
    """SI-SNR: SI-SDR of the zero-mean signals.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import scale_invariant_signal_noise_ratio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(scale_invariant_signal_noise_ratio(preds, target)), 4)
        15.0918
    """
    return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=True)
