"""Native P.862-structure PESQ core (numpy, host-side): a copy of
``metrics_tpu/functional/audio/_pesq_core.py``, code unchanged, so that the
port's scores are the JAX package's bits for the same float32 arrays.

The reference delegates PESQ to the compiled ``pesq`` package
(torchmetrics' functional/audio/pesq.py:83-101), absent in
egress-free environments. This module implements the ITU-T P.862
narrowband pipeline structure (and the P.862.2 wideband variant) natively:

    level alignment -> receive filtering (IRS-style for nb, 100 Hz
    high-pass for wb) -> envelope-correlation time alignment -> Hann
    frame power spectra -> Bark-band binning -> per-frame gain/frequency
    compensation -> Zwicker-law loudness -> masked symmetric +
    asymmetric disturbance -> L6/L2 two-stage time aggregation ->
    4.5 - 0.1 D - 0.0309 DA -> P.862.1 / P.862.2 MOS-LQO mapping.

Calibration status — read before trusting absolute values: the pipeline
STRUCTURE and the published aggregation/mapping constants follow the ITU
algorithm. **Narrowband uses the exact published ITU P.862 tables**: the
42-band Bark centres/widths, the band-centre frequencies (the P.862
modified bark scale), and the absolute-threshold band powers — all
transcribed from the public reference implementation and verified by
internal-consistency tests (tests/audio/test_pesq_native.py::
TestItuTables); the standard IRS receive magnitude table is likewise a
transcription of the published piecewise-dB filter table (no comparable
internal-consistency certificate exists for it). Wideband (P.862.2)
still derives its 49-band structure from the published formulas (Zwicker
bark scale, Terhardt threshold) in lieu of the ITU tables. Remaining
structural simplifications in BOTH modes: a single global delay estimate
instead of the ITU's per-utterance re-alignment, and mean-power-density
binning instead of the ITU's per-FFT-bin band allocation. Each mode is
anchored to the reference's documented ``pesq``-package outputs (nb
2.2076 / wb 1.7359 on the seed-1 doctest pair, reproduced exactly in the
battery within ±0.05 MOS), and behavior (SNR monotonicity, ~4.55/4.64
identical-signal ceilings, range, delay/gain forgiveness) is pinned over
a 54-case corpus — but scores are NOT bit-calibrated to the ``pesq``
package. ``tools/record_pesq_goldens.py`` records the real package's
outputs wherever it IS installed; ``tests/audio/pesq_goldens.json`` then
pins this core per-case. When the ``pesq`` package is importable, the
public functional uses it directly (exact reference parity) and this
core is bypassed.
"""
import functools as _functools
from typing import Tuple

import numpy as np

# ------------------------------------------------------------ psychoacoustics


def _bark(f: np.ndarray) -> np.ndarray:
    """Zwicker's critical-band rate (bark) for frequency in Hz."""
    f = np.asarray(f, np.float64)
    return 13.0 * np.arctan(7.6e-4 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _abs_threshold_db(f_hz: np.ndarray) -> np.ndarray:
    """Terhardt's absolute hearing threshold (dB SPL) at frequency f."""
    f = np.maximum(np.asarray(f_hz, np.float64), 20.0) / 1000.0
    return 3.64 * f**-0.8 - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2) + 1e-3 * f**4


# --------------------------------------------------- ITU P.862 narrowband tables
# Transcribed from the publicly available ITU-T P.862 reference implementation
# (42 Bark bands, narrowband). Transcription verified by internal consistency
# (tests/audio/test_pesq_native.py::TestItuTables): the bark centres match the
# cumulative-width ladder to <4e-6, the (bark, Hz) centre pairs decode the
# P.862 modified bark scale (exactly 100 Hz/bark through the linear segment),
# and the absolute-threshold powers decode to round one-decimal dB values —
# none of which survives a mis-transcription.

_NB_CENTRE_BARK = np.array([
    0.078672, 0.316341, 0.636559, 0.961246, 1.290450, 1.624217, 1.962597,
    2.305636, 2.653383, 3.005889, 3.363201, 3.725371, 4.092449, 4.464486,
    4.841533, 5.223642, 5.610866, 6.003256, 6.400869, 6.803755, 7.211971,
    7.625571, 8.044611, 8.469146, 8.899232, 9.334927, 9.776288, 10.223374,
    10.676242, 11.134952, 11.599563, 12.070135, 12.546731, 13.029408,
    13.518232, 14.013264, 14.514566, 15.022202, 15.536238, 16.056736,
    16.583761, 17.117382])

_NB_WIDTH_BARK = np.array([
    0.157344, 0.317994, 0.322441, 0.326934, 0.331474, 0.336061, 0.340697,
    0.345381, 0.350114, 0.354897, 0.359729, 0.364611, 0.369544, 0.374529,
    0.379565, 0.384653, 0.389794, 0.394989, 0.400236, 0.405538, 0.410894,
    0.416306, 0.421773, 0.427297, 0.432877, 0.438514, 0.444209, 0.449962,
    0.455774, 0.461645, 0.467577, 0.473569, 0.479621, 0.485736, 0.491912,
    0.498151, 0.504454, 0.510819, 0.517250, 0.523745, 0.530308, 0.536934])

_NB_CENTRE_HZ = np.array([
    7.867213, 31.634144, 63.655895, 96.124611, 129.044968, 162.421738,
    196.259659, 230.563568, 265.338348, 300.588867, 336.320129, 372.537109,
    409.244934, 446.448578, 484.568604, 526.600586, 570.303833, 619.423340,
    672.121643, 728.525696, 785.675964, 846.835693, 909.691650, 977.063293,
    1049.861694, 1129.635986, 1217.257568, 1312.109497, 1412.501465,
    1517.999390, 1628.894165, 1746.194336, 1871.568848, 2008.776123,
    2158.979248, 2326.743164, 2513.787109, 2722.488770, 2952.586670,
    3205.835449, 3492.679932, 3820.219238])

_NB_ABS_THRESH_POWER = np.array([
    51286152.0, 2454709.5, 70794.59375, 4897.788574, 1174.897705,
    389.045166, 104.712860, 45.708820, 17.782795, 9.772372, 4.897789,
    3.090296, 1.905461, 1.258925, 0.977237, 0.724436, 0.562341, 0.457088,
    0.389045, 0.331131, 0.295121, 0.269153, 0.257040, 0.251189, 0.251189,
    0.251189, 0.251189, 0.263027, 0.288403, 0.309030, 0.338844, 0.371535,
    0.398107, 0.436516, 0.467735, 0.489779, 0.501187, 0.501187, 0.512861,
    0.524807, 0.524807, 0.524807])


def _nb_band_edges_hz() -> np.ndarray:
    """Band edges (Hz) from the ITU bark ladder via the P.862 bark scale.

    Edges in bark are the cumulative width ladder; the bark->Hz map is the
    monotone interpolation through the ITU (centre_bark, centre_hz) pairs,
    linearly extrapolated at the ends with the boundary slope.
    """
    edges_bark = np.concatenate([[0.0], np.cumsum(_NB_WIDTH_BARK)])
    slopes = np.diff(_NB_CENTRE_HZ) / np.diff(_NB_CENTRE_BARK)
    lo_hz = _NB_CENTRE_HZ[0] - slopes[0] * _NB_CENTRE_BARK[0]
    hi_hz = _NB_CENTRE_HZ[-1] + slopes[-1] * (edges_bark[-1] - _NB_CENTRE_BARK[-1])
    return np.interp(
        edges_bark,
        np.concatenate([[0.0], _NB_CENTRE_BARK, [edges_bark[-1]]]),
        np.concatenate([[max(lo_hz, 0.0)], _NB_CENTRE_HZ, [hi_hz]]),
    )


class _Params:
    """Per-mode constants. [ITU] = published P.862 value; [approx] = derived
    from the published formula in lieu of the ITU lookup table."""

    def __init__(self, fs: int, mode: str):
        self.fs = fs
        self.mode = mode
        self.frame = 256 if fs == 8000 else 512          # 32 ms [ITU]
        self.shift = self.frame // 2                     # 50% overlap [ITU]
        self.n_bands = 42 if mode == "nb" else 49        # [ITU]
        if mode == "nb":
            # exact published P.862 narrowband tables [ITU]
            self.band_edges_hz = _nb_band_edges_hz()
            self.band_centers_hz = _NB_CENTRE_HZ.copy()
            self.band_width_bark = _NB_WIDTH_BARK.copy()
            self.abs_thresh_power = _NB_ABS_THRESH_POWER.copy()
        else:
            # wideband (P.862.2): band structure from the published formulas
            # in lieu of the ITU tables [approx]
            f_lo, f_hi = 100.0, 8000.0
            edges_bark = np.linspace(_bark(f_lo), _bark(f_hi), self.n_bands + 1)
            # invert the bark scale numerically for band edges in Hz [approx]
            grid_f = np.linspace(0.0, fs / 2.0, 4096)
            self.band_edges_hz = np.interp(edges_bark, _bark(grid_f), grid_f)
            self.band_centers_hz = 0.5 * (self.band_edges_hz[1:] + self.band_edges_hz[:-1])
            self.band_width_bark = np.diff(edges_bark)
            # hearing threshold as band power (arbitrary model scale) [approx]
            self.abs_thresh_power = 10.0 ** (_abs_threshold_db(self.band_centers_hz) / 10.0)
        # Zwicker loudness scaling [ITU]
        self.sl = 1.866775e-1
        self.zwicker_power = 0.23
        # disturbance aggregation: d_weight is the published ITU value;
        # a_weight is the published 0.0309 times a per-mode calibration
        # factor (nb 0.351, wb 0.857). The remaining structural
        # approximations (simplified time alignment, mean-density binning
        # instead of the ITU's per-bin allocation) inflate the asymmetric
        # channel, and the factor re-anchors each mode to the reference's
        # documented doctest output (torch seed-1 randn pair: nb 2.2076,
        # wb 1.7359, ref functional/audio/pesq.py:69-71); the nb factor was
        # re-derived after the exact ITU band/threshold tables landed.
        # Independent behavior (monotonicity vs SNR, the 4.55
        # identical-signal ceiling, range) is pinned separately in
        # tests/audio/test_pesq_native.py.
        self.d_weight = 0.1
        self.a_weight = 0.0309 * (0.351 if mode == "nb" else 0.857)
        # SPL calibration: the ITU model normalizes spectra so the standard
        # listening level corresponds to ~79 dB SPL; derive the factor from
        # a 1 kHz tone at the standard power through this pipeline [ITU
        # scheme, approx constant]
        tone = np.sqrt(2.0 * _TARGET_POWER) * np.sin(
            2.0 * np.pi * 1000.0 * np.arange(4 * self.frame) / fs
        )
        self.power_scale = 1.0
        peak = _band_powers(tone, self).max()
        self.power_scale = 10.0**7.9 / peak


# ------------------------------------------------------------- preprocessing


def _fft_filter(x: np.ndarray, fs: int, breakpoints_hz, gains_db) -> np.ndarray:
    """Zero-phase FFT filter with a piecewise-linear dB magnitude response."""
    n = len(x)
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(n, 1.0 / fs)
    gains = np.interp(freqs, breakpoints_hz, gains_db)
    spec *= 10.0 ** (gains / 20.0)
    return np.fft.irfft(spec, n)


# Standard IRS receive characteristic for narrowband, piecewise dB —
# transcribed from the published P.862 standard-IRS-filter table (the
# telephone-band emphasis applied before the perceptual model) [ITU]
_IRS_BREAKS_HZ = [0, 50, 100, 125, 160, 200, 250, 300, 350, 400, 500, 600,
                  700, 800, 1000, 1300, 1600, 2000, 2500, 3000, 3250, 3500,
                  4000]
_IRS_GAINS_DB = [-200.0, -40.0, -20.0, -12.0, -6.0, 0.0, 4.0, 6.0, 8.0, 10.0,
                 11.0, 12.0, 12.0, 12.0, 12.0, 12.0, 12.0, 12.0, 11.0, 8.0,
                 4.0, -40.0, -200.0]

# wideband input filter: first-order-style 100 Hz high-pass expressed as a
# piecewise response (P.862.2 drops the IRS filter) [approx]
_WB_BREAKS_HZ = [0, 50, 100, 150, 8000, 24000]
_WB_GAINS_DB = [-200.0, -12.0, -3.0, 0.0, 0.0, 0.0]

_TARGET_POWER = 1e7  # standard listening-level power after alignment [ITU]


def _level_align(x: np.ndarray, fs: int) -> np.ndarray:
    """Scale to the standard level using 350-3250 Hz band power [ITU scheme]."""
    band = _fft_filter(x, fs, [0, 300, 350, 3250, 3300, fs / 2], [-200.0, -30.0, 0.0, 0.0, -30.0, -200.0])
    power = float(np.mean(band**2)) + 1e-20
    return x * np.sqrt(_TARGET_POWER / power)


def _crude_align(ref: np.ndarray, deg: np.ndarray, frame: int) -> int:
    """Whole-signal delay estimate via frame-energy cross-correlation.

    The full ITU alignment additionally splits utterances and re-aligns
    each; model-output evaluation pairs are already sample-aligned, where
    this reduces to delay 0. [approx: single global delay]
    """
    hop = frame // 4
    n = min(len(ref), len(deg)) // hop - 1
    if n < 4:
        return 0
    env_r = np.log1p(np.add.reduceat(ref[: n * hop] ** 2, np.arange(0, n * hop, hop)))
    env_d = np.log1p(np.add.reduceat(deg[: n * hop] ** 2, np.arange(0, n * hop, hop)))
    env_r -= env_r.mean()
    env_d -= env_d.mean()
    corr = np.correlate(env_d, env_r, mode="full")
    delay_frames = int(np.argmax(corr)) - (n - 1)
    max_shift = n // 4
    delay_frames = int(np.clip(delay_frames, -max_shift, max_shift))
    return delay_frames * hop


# ---------------------------------------------------------------- main model


def _band_powers(x: np.ndarray, p: _Params) -> np.ndarray:
    """(num_frames, n_bands) Hann-windowed power spectra binned to Bark."""
    n_frames = (len(x) - p.frame) // p.shift + 1
    if n_frames < 1:
        raise ValueError(
            f"PESQ needs at least {p.frame} samples at fs={p.fs} (one 32 ms frame); got {len(x)}"
        )
    idx = np.arange(p.frame)[None, :] + p.shift * np.arange(n_frames)[:, None]
    frames = x[idx] * np.hanning(p.frame)[None, :]
    spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2
    freqs = np.fft.rfftfreq(p.frame, 1.0 / p.fs)
    # mean power density per Bark band (excludes the DC bin like the ITU model)
    bands = np.empty((n_frames, p.n_bands))
    for b in range(p.n_bands):
        lo, hi = p.band_edges_hz[b], p.band_edges_hz[b + 1]
        sel = (freqs >= lo) & (freqs < hi) & (freqs > 0)
        bands[:, b] = spec[:, sel].mean(axis=1) if sel.any() else 0.0
    # calibrate onto the model's dB-SPL power scale (see _Params)
    return bands * (p.power_scale / p.frame)


def _loudness(bands: np.ndarray, p: _Params) -> np.ndarray:
    """Zwicker-law specific loudness per Bark band [ITU formula]."""
    p0 = p.abs_thresh_power[None, :]
    ratio = np.maximum(bands / (0.5 * p0), 0.0)
    loud = p.sl * (p0 / 0.5) ** p.zwicker_power * ((0.5 + 0.5 * ratio) ** p.zwicker_power - 1.0)
    return np.maximum(loud, 0.0)


def _frame_gain_compensation(ref_b: np.ndarray, deg_b: np.ndarray, p: _Params) -> Tuple[np.ndarray, np.ndarray]:
    """Partial per-frame gain + per-band frequency compensation [ITU scheme]:
    the degraded signal's band powers are scaled toward the reference's
    with bounded ratios, so constant filtering/gain is mostly forgiven."""
    # per-band spectral compensation over active frames (bounded 0.01..100);
    # 1e7 on the SPL power scale is the ITU speech-active criterion
    audible = ref_b.sum(axis=1) > 1e7
    if audible.any():
        num = ref_b[audible].sum(axis=0) + 1e3
        den = deg_b[audible].sum(axis=0) + 1e3
        band_pow_ratio = np.clip(num / den, 1e-2, 1e2)
    else:
        band_pow_ratio = np.ones(p.n_bands)
    deg_b = deg_b * band_pow_ratio[None, :]
    # per-frame gain compensation of the reference toward the degraded
    num = (deg_b * ref_b).sum(axis=1) + 5e3
    den = (ref_b**2).sum(axis=1) + 5e3
    frame_gain = np.clip(num / den, 3e-4, 5.0)
    ref_b = ref_b * frame_gain[:, None]
    return ref_b, deg_b


def _disturbance(ref_b: np.ndarray, deg_b: np.ndarray, p: _Params) -> Tuple[np.ndarray, np.ndarray]:
    """Per-frame symmetric and asymmetric disturbances [ITU scheme]."""
    l_ref = _loudness(ref_b, p)
    l_deg = _loudness(deg_b, p)
    raw = l_deg - l_ref
    # masking: deadzone of a quarter of the smaller loudness [ITU]
    mask = 0.25 * np.minimum(l_ref, l_deg)
    d = np.where(raw > mask, raw - mask, np.where(raw < -mask, raw + mask, 0.0))
    # symmetric frame disturbance: width-weighted pseudo-L2 over bands [ITU]
    w = p.band_width_bark[None, :]
    d_frame = np.sqrt(((np.abs(d) * w) ** 2).sum(axis=1))
    # asymmetry factor: additive degradations weigh more [ITU]
    h = ((deg_b + 50.0) / (ref_b + 50.0)) ** 1.2
    h = np.where(h < 3.0, 0.0, np.minimum(h, 12.0))
    da_frame = (np.abs(d) * h * w).sum(axis=1)
    return d_frame, da_frame


def _two_stage_norm(x: np.ndarray, weights: np.ndarray, split: int, p1: float, p2: float) -> float:
    """Lp1 over `split`-frame windows, then Lp2 over windows [ITU: 20-frame
    split-second L6, then L2 over time], energy-weighted per frame."""
    n = len(x)
    if n == 0:
        return 0.0
    pad = (-n) % split
    xw = np.pad(x * weights, (0, pad))
    ww = np.pad(weights, (0, pad))
    xw = xw.reshape(-1, split)
    ww = ww.reshape(-1, split)
    per_win = (np.sum(xw**p1, axis=1) / (np.sum(ww**p1, axis=1) + 1e-20)) ** (1.0 / p1)
    return float((np.mean(per_win**p2)) ** (1.0 / p2))


def _raw_pesq(ref: np.ndarray, deg: np.ndarray, p: _Params) -> float:
    ref = np.asarray(ref, np.float64)
    deg = np.asarray(deg, np.float64)
    if ref.shape != deg.shape:
        raise ValueError(f"Expected same shapes, got {ref.shape} and {deg.shape}")

    ref = _level_align(ref, p.fs)
    deg = _level_align(deg, p.fs)
    if p.mode == "nb":
        ref = _fft_filter(ref, p.fs, _IRS_BREAKS_HZ, _IRS_GAINS_DB)
        deg = _fft_filter(deg, p.fs, _IRS_BREAKS_HZ, _IRS_GAINS_DB)
    else:
        ref = _fft_filter(ref, p.fs, _WB_BREAKS_HZ, _WB_GAINS_DB)
        deg = _fft_filter(deg, p.fs, _WB_BREAKS_HZ, _WB_GAINS_DB)

    delay = _crude_align(ref, deg, p.frame)
    if delay > 0:
        ref, deg = ref[: len(ref) - delay], deg[delay:]
    elif delay < 0:
        ref, deg = ref[-delay:], deg[: len(deg) + delay]

    ref_b = _band_powers(ref, p)
    deg_b = _band_powers(deg, p)
    ref_b, deg_b = _frame_gain_compensation(ref_b, deg_b, p)
    d_frame, da_frame = _disturbance(ref_b, deg_b, p)

    # frame weighting by reference audible power (silent frames count
    # less): ((E + 1e5)/1e5)^0.04 [ITU]
    frame_energy = ref_b.sum(axis=1)
    weights = ((frame_energy + 1e5) / 1e5) ** 0.04

    d_total = _two_stage_norm(d_frame, weights, split=20, p1=6.0, p2=2.0)
    da_total = _two_stage_norm(da_frame, weights, split=20, p1=6.0, p2=2.0)

    return 4.5 - p.d_weight * d_total - p.a_weight * da_total


def _mos_lqo(raw: float, mode: str) -> float:
    """P.862.1 (nb) / P.862.2 (wb) raw-score -> MOS-LQO mapping [ITU]."""
    if mode == "nb":
        return 0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607))
    return 0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224))


def pesq_native(fs: int, ref: np.ndarray, deg: np.ndarray, mode: str) -> float:
    """PESQ MOS-LQO via the native P.862-structure core.

    Same argument order as ``pesq.pesq`` (fs, reference, degraded, mode).
    See the module docstring for the calibration status.
    """
    if fs not in (8000, 16000):
        raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
    if mode not in ("wb", "nb"):
        raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
    if mode == "wb" and fs != 16000:
        # the pesq package raises here too (wide-band is 16 kHz only);
        # silently computing would collapse the top Bark bands onto fs/2
        raise ValueError("`mode='wb'` requires `fs=16000` (ITU P.862.2 is 16 kHz only)")
    params = _cached_params(fs, mode)
    raw = _raw_pesq(ref, deg, params)
    return float(np.clip(_mos_lqo(raw, mode), 1.0, 4.64))


@_functools.lru_cache(maxsize=4)
def _cached_params(fs: int, mode: str) -> _Params:
    """(fs, mode) -> immutable _Params; the bark inversion + calibration
    tone run once per mode, not once per batched sample."""
    return _Params(fs, mode)
