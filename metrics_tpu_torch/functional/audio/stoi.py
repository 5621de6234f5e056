"""Short-Time Objective Intelligibility: port of ``metrics_tpu/functional/audio/stoi.py``.

The whole measure runs batched over ``(N, T)`` on the input's device, with
static shapes: resampling to 10 kHz (zero-stuffing, then the 513-tap Kaiser
FIR as one strided ``conv1d``), silent-frame removal as *compaction* (the
frames of the clean signal within 40 dB of its loudest are stably moved to
the front and overlap-added; a per-row kept count ``K`` masks every later
reduction), the STFT (``rfft`` of 512), the third-octave bands (one product
with a 0/1 band matrix) and the short-time segment correlations, standard
(Taal et al. 2011) or extended (Jensen & Taal 2016). Nothing reads a value
back to the host. The convolution and the band product run in full float32:
cuDNN's and cuBLAS's TF32 are off for the call and restored after it.

Every sample of the overlap-add gets at most two addends, so the order in
which they land cannot change its bits.
"""
import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from metrics_tpu_torch.functional.image.helper import _full_float32
from metrics_tpu_torch.utilities.checks import _check_same_shape

_FS = 10_000  # internal sample rate (Hz)
_N_FRAME = 256  # analysis window length at 10 kHz (25.6 ms)
_HOP = _N_FRAME // 2
_NFFT = 512
_NUM_BANDS = 15  # third-octave bands
_MIN_FREQ = 150.0  # center frequency of the lowest band (Hz)
_SEG = 30  # frames per short-time segment (384 ms)
_BETA = -15.0  # lower signal-to-distortion bound (dB)
_DYN_RANGE = 40.0  # silent-frame energy range (dB)
_EPS = float(np.finfo(np.float64).eps)


def _third_octave_matrix(fs: int, nfft: int, num_bands: int, min_freq: float) -> np.ndarray:
    """(num_bands, nfft//2+1) 0/1 matrix grouping rfft bins into bands, the
    band edges snapped to the nearest bin as pystoi's ``thirdoct`` snaps them."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands, dtype=np.float64)
    freq_low = min_freq * 2.0 ** ((2 * k - 1) / 6)
    freq_high = min_freq * 2.0 ** ((2 * k + 1) / 6)
    obm = np.zeros((num_bands, len(f)), dtype=np.float32)
    for i in range(num_bands):
        lo = int(np.argmin(np.square(f - freq_low[i])))
        hi = int(np.argmin(np.square(f - freq_high[i])))
        obm[i, lo:hi] = 1.0
    return obm


def _hann_inner(n: int) -> np.ndarray:
    """np.hanning(n + 2)[1:-1]: the window pystoi applies to every frame."""
    return np.hanning(n + 2)[1:-1].astype(np.float32)


def _octave_resample_filter(up: int, down: int, n: int = 32) -> np.ndarray:
    """The Octave-compatible anti-alias FIR pystoi resamples with: the odd
    symmetric kaiser(beta=5) windowed sinc of ``2*n*max(up, down) + 1`` taps,
    cutoff ``1/max(up, down)`` of Nyquist, scaled by ``up``."""
    from scipy.signal import firwin

    pqmax = max(up, down)
    h = firwin(2 * n * pqmax + 1, 1.0 / pqmax, window=("kaiser", 5.0))
    return (h * up).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _resample_kernel(up: int, down: int, device: torch.device) -> Tensor:
    """The FIR flipped, as ``conv1d``'s ``(1, 1, taps)`` weight (``conv1d`` correlates)."""
    return torch.from_numpy(_octave_resample_filter(up, down)[::-1].copy()).to(device).reshape(1, 1, -1)


@functools.lru_cache(maxsize=None)
def _frame_window(n: int, device: torch.device) -> Tensor:
    return torch.from_numpy(_hann_inner(n)).to(device)


@functools.lru_cache(maxsize=None)
def _band_matrix_t(device: torch.device) -> Tensor:
    """The third-octave matrix transposed: ``(nfft//2+1, bands)``."""
    return torch.from_numpy(np.ascontiguousarray(_third_octave_matrix(_FS, _NFFT, _NUM_BANDS, _MIN_FREQ).T)).to(device)


def _resample_to_10k(x: Tensor, fs: int) -> Tensor:
    """The rows of ``x`` (``(N, T)``) resampled from ``fs`` to 10 kHz as the
    JAX package resamples them (zero-stuffing by ``up``, the FIR, every
    ``down``-th sample): ``ceil(T * up / down)`` samples a row."""
    if fs == _FS:
        return x
    g = math.gcd(int(fs), _FS)
    up, down = _FS // g, fs // g
    h = _resample_kernel(up, down, x.device)
    half_len = (h.shape[-1] - 1) // 2
    n_rows, n_in = x.shape
    x_up = F.pad(x[..., None], (0, up - 1)).reshape(n_rows, n_in * up)  # zero-stuffed
    x_up = F.pad(x_up, (half_len, half_len))[:, None, :]
    with _full_float32():
        # the 'full' convolution's centre, every down-th sample of it
        return F.conv1d(x_up, h, stride=down)[:, 0]


def _n_frames(length: int, framelen: int, hop: int) -> int:
    """Frames at ``hop`` spacing as pystoi's ``range(0, length - framelen, hop)``
    counts them: one starting exactly at ``length - framelen`` is dropped."""
    return max(-(-(length - framelen) // hop), 0)


def _frame(x: Tensor, framelen: int, hop: int) -> Tensor:
    """``(N, frames, framelen)`` frames of the rows of ``x``."""
    return x.unfold(-1, framelen, hop)[:, : _n_frames(x.shape[-1], framelen, hop)]


def _compact_loud_frames(x: Tensor, y: Tensor, framelen: int, hop: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Silent-frame removal with static shapes.

    The frames of the clean rows ``x`` more than ``_DYN_RANGE`` dB below the
    row's loudest are dropped from both signals: the kept frames move stably
    to the front and are overlap-added at their new places. Returns the two
    rebuilt signals and the per-row kept count ``K`` (frames past ``K`` are
    silence and are masked later).
    """
    w = _frame_window(framelen, x.device)
    xf = _frame(x, framelen, hop) * w
    yf = _frame(y, framelen, hop) * w
    energies = 20.0 * torch.log10(torch.linalg.vector_norm(xf, dim=-1) + _EPS)
    keep = energies > (energies.max(dim=-1, keepdim=True).values - _DYN_RANGE)
    k_count = keep.sum(dim=-1)
    order = torch.argsort((~keep).to(torch.uint8), dim=-1, stable=True)  # kept frames first, in order
    n_frames = xf.shape[1]
    kept = (torch.arange(n_frames, device=x.device) < k_count[:, None]).to(xf.dtype)[..., None]
    out_len = (n_frames - 1) * hop + framelen

    def overlap_add(frames: Tensor) -> Tensor:
        frames = torch.gather(frames, 1, order[..., None].expand_as(frames)) * kept
        return F.fold(frames.transpose(1, 2), (1, out_len), (1, framelen), stride=(1, hop))[:, 0, 0]

    return overlap_add(xf), overlap_add(yf), k_count


def _band_spectrogram(x: Tensor) -> Tensor:
    """``(N, bands, frames)`` third-octave magnitudes of the windowed rfft frames."""
    frames = _frame(x, _N_FRAME, _HOP) * _frame_window(_N_FRAME, x.device)
    spec = torch.fft.rfft(frames, n=_NFFT, dim=-1)
    power = spec.abs().square().to(torch.float32)  # (N, frames, nfft//2+1)
    with _full_float32():
        return torch.sqrt(power @ _band_matrix_t(x.device)).transpose(1, 2)


def _segments(tob: Tensor) -> Tensor:
    """``(N, S, bands, _SEG)`` sliding short-time segments (stride one frame)."""
    return tob.unfold(-1, _SEG, 1).permute(0, 2, 1, 3)


def _norm(x: Tensor, dim: int) -> Tensor:
    return torch.linalg.vector_norm(x, dim=dim, keepdim=True)


def _stoi_d(x_seg: Tensor, y_seg: Tensor, seg_mask: Tensor) -> Tensor:
    """Standard STOI: the masked mean of the per-(segment, band) correlations."""
    y_n = y_seg * (_norm(x_seg, -1) / (_norm(y_seg, -1) + _EPS))
    clip_value = 10.0 ** (-_BETA / 20.0)
    y_p = torch.minimum(y_n, x_seg * (1.0 + clip_value))
    y_p = y_p - y_p.mean(dim=-1, keepdim=True)
    x_c = x_seg - x_seg.mean(dim=-1, keepdim=True)
    y_p = y_p / (_norm(y_p, -1) + _EPS)
    x_c = x_c / (_norm(x_c, -1) + _EPS)
    corr = (y_p * x_c).sum(dim=-1) * seg_mask[..., None]  # (N, S, bands)
    denom = seg_mask.sum(dim=-1).clamp(min=1.0) * corr.shape[-1]
    return corr.sum(dim=(1, 2)) / denom


def _row_col_normalize(seg: Tensor) -> Tensor:
    """Zero-mean unit-norm rows, then zero-mean unit-norm columns, of each
    ``(bands, _SEG)`` segment (pystoi's ``row_col_normalize`` without its
    random jitter)."""
    seg = seg - seg.mean(dim=-1, keepdim=True)
    seg = seg / (_norm(seg, -1) + _EPS)
    seg = seg - seg.mean(dim=-2, keepdim=True)
    return seg / (_norm(seg, -2) + _EPS)


def _estoi_d(x_seg: Tensor, y_seg: Tensor, seg_mask: Tensor) -> Tensor:
    """Extended STOI: the masked mean of the per-segment normalised inner products."""
    per_seg = (_row_col_normalize(x_seg) * _row_col_normalize(y_seg)).sum(dim=(-2, -1)) / _SEG  # (N, S)
    return (per_seg * seg_mask).sum(dim=-1) / seg_mask.sum(dim=-1).clamp(min=1.0)


def _stoi_rows(target: Tensor, preds: Tensor, fs: int, extended: bool) -> Tensor:
    """STOI of each row pair of ``(N, T)`` clean and degraded signals: ``(N,)`` float32."""
    x = _resample_to_10k(target.to(torch.float32), fs)
    y = _resample_to_10k(preds.to(torch.float32), fs)
    n_frames = _n_frames(x.shape[-1], _N_FRAME, _HOP)
    # the rebuilt signal re-frames into n_frames - 1 frames (its boundary frame is dropped)
    n_segments = n_frames - 1 - _SEG + 1
    if n_segments <= 0:  # too short for one segment, whatever is kept: pystoi's 1e-5
        return torch.full(x.shape[:1], 1e-5, dtype=torch.float32, device=x.device)
    x, y, k_count = _compact_loud_frames(x, y, _N_FRAME, _HOP)
    x_seg = _segments(_band_spectrogram(x))
    y_seg = _segments(_band_spectrogram(y))
    # segment s spans frames [s, s + _SEG) and must lie inside the K - 1 valid frames
    seg_mask = (torch.arange(n_segments, device=x.device) + _SEG <= k_count[:, None] - 1).to(torch.float32)
    d = _estoi_d(x_seg, y_seg, seg_mask) if extended else _stoi_d(x_seg, y_seg, seg_mask)
    return torch.where(seg_mask.sum(dim=-1) > 0, d, torch.full_like(d, 1e-5))


def short_time_objective_intelligibility(
    preds: Tensor, target: Tensor, fs: int, extended: bool = False, keep_same_device: bool = False
) -> Tensor:
    """STOI of ``preds`` (degraded) against ``target`` (clean), both ``[..., time]``
    at ``fs`` Hz: float32 of shape ``[...]``, on the inputs' device.

    Args:
        preds: degraded speech, shape ``[..., time]``
        target: clean speech, shape ``[..., time]``
        fs: sampling frequency of the inputs (Hz); resampled to 10 kHz inside
        extended: the extended STOI (Jensen & Taal 2016)
        keep_same_device: accepted for the reference's signature; the value
            is on the inputs' device either way

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import short_time_objective_intelligibility
        >>> g = torch.Generator().manual_seed(42)
        >>> preds, target = torch.randn(8000, generator=g), torch.randn(8000, generator=g)
        >>> float(short_time_objective_intelligibility(preds, target, 8000)) < 0.1
        True
    """
    _check_same_shape(preds, target)
    del keep_same_device
    flat_p = preds.reshape(-1, preds.shape[-1])
    flat_t = target.reshape(-1, target.shape[-1])
    return _stoi_rows(flat_t, flat_p, fs, extended).reshape(preds.shape[:-1])
