"""SDR and SI-SDR: port of ``metrics_tpu/functional/audio/sdr.py``.

SDR fits the optimal distortion filter of ``filter_length`` taps: FFT auto-
and cross-correlations (cuFFT on the card), a symmetric Toeplitz system built
by a gather and solved batched by ``torch.linalg.solve_ex``. A singular
system gives the non-finite value the JAX package's ``jnp.linalg.solve``
gives; nothing raises and nothing reads the solver's status back to the host.
"""
import math
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utilities.checks import _check_same_shape


def _symmetric_toeplitz(vector: Tensor) -> Tensor:
    """Symmetric Toeplitz matrix from its first row (over the trailing axis).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional.audio.sdr import _symmetric_toeplitz
        >>> _symmetric_toeplitz(torch.tensor([0, 1, 2, 3]))
        tensor([[0, 1, 2, 3],
                [1, 0, 1, 2],
                [2, 1, 0, 1],
                [3, 2, 1, 0]])
    """
    idx = torch.arange(vector.shape[-1], device=vector.device)
    return vector[..., (idx[:, None] - idx[None, :]).abs()]


def _compute_autocorr_crosscorr(target: Tensor, preds: Tensor, corr_len: int) -> Tuple[Tensor, Tensor]:
    """The first ``corr_len`` lags of ``target``'s autocorrelation and of its
    cross-correlation with ``preds``, through FFTs of length
    ``2 ** ceil(log2(len(preds) + len(target) - 1))``."""
    n_fft = 2 ** math.ceil(math.log2(preds.shape[-1] + target.shape[-1] - 1))

    t_fft = torch.fft.rfft(target, n=n_fft, dim=-1)
    r_0 = torch.fft.irfft(t_fft.real**2 + t_fft.imag**2, n=n_fft, dim=-1)[..., :corr_len]

    p_fft = torch.fft.rfft(preds, n=n_fft, dim=-1)
    b = torch.fft.irfft(torch.conj(t_fft) * p_fft, n=n_fft, dim=-1)[..., :corr_len]

    return r_0, b


def signal_distortion_ratio(
    preds: Tensor,
    target: Tensor,
    use_cg_iter: Optional[int] = None,
    filter_length: int = 512,
    zero_mean: bool = False,
    load_diag: Optional[float] = None,
) -> Tensor:
    """SDR in dB via the optimal distortion filter, over the trailing time axis.

    The working dtype follows ``preds``: float64 input is solved in float64
    and returns float64 (the JAX package with x64 on); any other input is
    solved in float32 and returns float32 (the JAX package with x64 off),
    where, unless ``load_diag`` is given, the autocorrelation's zero lag is
    scaled by ``1 + 1e-6`` to keep near-singular systems solvable.
    ``use_cg_iter`` is accepted and unused, as in the JAX package: the solve
    is always exact.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import signal_distortion_ratio
        >>> g = torch.Generator().manual_seed(0)
        >>> preds, target = torch.randn(8000, generator=g), torch.randn(8000, generator=g)
        >>> float(signal_distortion_ratio(preds, target)) < 0
        True
    """
    _check_same_shape(preds, target)
    work_dtype = torch.float64 if preds.dtype == torch.float64 else torch.float32
    preds = preds.to(work_dtype)
    target = target.to(work_dtype)

    if zero_mean:
        preds = preds - preds.mean(dim=-1, keepdim=True)
        target = target - target.mean(dim=-1, keepdim=True)

    target = target / torch.linalg.vector_norm(target, dim=-1, keepdim=True).clamp(min=1e-6)
    preds = preds / torch.linalg.vector_norm(preds, dim=-1, keepdim=True).clamp(min=1e-6)

    r_0, b = _compute_autocorr_crosscorr(target, preds, corr_len=filter_length)
    if load_diag is not None:
        r_0 = torch.cat((r_0[..., :1] + load_diag, r_0[..., 1:]), dim=-1)
    elif work_dtype == torch.float32:
        r_0 = torch.cat((r_0[..., :1] * (1.0 + 1e-6), r_0[..., 1:]), dim=-1)

    r = _symmetric_toeplitz(r_0)
    sol = torch.linalg.solve_ex(r, b[..., None], check_errors=False)[0][..., 0]

    coh = (b * sol).sum(dim=-1)
    ratio = coh / (1 - coh)
    return 10.0 * torch.log10(ratio)


def scale_invariant_signal_distortion_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """SI-SDR in dB over the trailing time axis.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import scale_invariant_signal_distortion_ratio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(scale_invariant_signal_distortion_ratio(preds, target)), 2)
        18.4
    """
    _check_same_shape(preds, target)
    eps = torch.finfo(preds.dtype).eps

    if zero_mean:
        target = target - target.mean(dim=-1, keepdim=True)
        preds = preds - preds.mean(dim=-1, keepdim=True)

    alpha = ((preds * target).sum(dim=-1, keepdim=True) + eps) / ((target**2).sum(dim=-1, keepdim=True) + eps)
    target_scaled = alpha * target
    noise = target_scaled - preds

    val = ((target_scaled**2).sum(dim=-1) + eps) / ((noise**2).sum(dim=-1) + eps)
    return 10 * torch.log10(val)
