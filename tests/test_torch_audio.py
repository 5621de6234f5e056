"""The port's audio metrics held against the JAX package on the CPU.

Built from the cases of ``tests/audio/test_audio.py``,
``test_audio_recorded_oracles.py``, ``test_stoi.py`` and
``test_pesq_wrapper.py``: the same seeded numpy signals go through
``metrics_tpu`` and ``metrics_tpu_torch``, functional and module, and the
recorded values of the reference's doctests hold in the port too.
Tolerances:

* exact: ``best_perm``, ``pit_permutate``, STOI's silent-frame compaction,
  PESQ (both packages run one numpy core on the same float32 arrays), the
  int32 counts, dtypes and shapes;
* SNR, SI-SNR, SI-SDR: rtol 1e-5 against JAX, 1e-4 against float64 numpy;
* SDR: the float32 solve's error in the coherence ``coh`` is magnified by
  ``1 / (1 - coh) = 1 + 10 ** (SDR / 10)``, so the tolerance in dB is
  ``2e-5 * (1 + 10 ** (SDR / 10))`` (4e-5 dB at 0 dB, 2e-3 dB at 20 dB,
  0.2 dB at 40 dB) against JAX and against float64
  ``scipy.linalg.solve_toeplitz``; float64 input (the JAX package's x64
  branch) within 1e-9 dB of both;
* STOI: atol 1e-6 against JAX, 2e-4 against the float64 replica of
  ``tests/audio/test_stoi.py``;
* a module's sum: rtol 1e-6 against JAX.
"""
import sys
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import solve_toeplitz

import metrics_tpu as J
import metrics_tpu.functional as jF
import metrics_tpu_torch as M
import metrics_tpu_torch.functional as tF
from metrics_tpu._compat import enable_x64
from metrics_tpu.dispatch import FastDispatchUnsupported as JaxUnsupported
from metrics_tpu.functional.audio import stoi as jax_stoi
from metrics_tpu.functional.audio.pit import _find_best_perm_by_linear_sum_assignment as jax_hungarian
from metrics_tpu_torch.dispatch import FastDispatchUnsupported
from metrics_tpu_torch.functional.audio import stoi as port_stoi
from metrics_tpu_torch.functional.audio.pit import (
    _find_best_perm_by_exhaustive_method,
    _find_best_perm_by_linear_sum_assignment,
)
from metrics_tpu_torch.interop import load_jax_state_dict, to_jax_state_dict
from tests.audio.pesq_corpus import build_corpus
from tests.audio.test_stoi import _numpy_stoi

PREDS4, TARGET4 = [2.5, 0.0, 2.0, 8.0], [3.0, -0.5, 2.0, 7.0]
RTOL, F64_RTOL, STOI_ATOL, STOI_F64_ATOL, SUM_RTOL = 1e-5, 1e-4, 1e-6, 2e-4, 1e-6
SDR_TOL_DB = 2e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _dtype(x):
    return str(x.dtype).replace("torch.", "")


def _sdr_tol(sdr):
    """The SDR tolerance in dB at each value (the module's docstring)."""
    return SDR_TOL_DB * (1 + 10 ** (np.nan_to_num(np.asarray(sdr, np.float64), nan=0.0) / 10))


def _signals(seed, shape, noise):
    rng = np.random.RandomState(seed)
    target = rng.randn(*shape).astype(np.float32)
    preds = (target + noise * rng.randn(*shape)).astype(np.float32)
    return preds, target


def _np_snr(preds, target, zero_mean=False):
    preds, target = np.asarray(preds, np.float64), np.asarray(target, np.float64)
    if zero_mean:
        preds = preds - preds.mean(-1, keepdims=True)
        target = target - target.mean(-1, keepdims=True)
    return 10 * np.log10((target**2).sum(-1) / ((target - preds) ** 2).sum(-1))


def _np_si_sdr(preds, target, zero_mean=False):
    preds, target = np.asarray(preds, np.float64), np.asarray(target, np.float64)
    if zero_mean:
        preds = preds - preds.mean(-1, keepdims=True)
        target = target - target.mean(-1, keepdims=True)
    alpha = (preds * target).sum(-1, keepdims=True) / (target**2).sum(-1, keepdims=True)
    scaled = alpha * target
    return 10 * np.log10((scaled**2).sum(-1) / ((scaled - preds) ** 2).sum(-1))


def _np_sdr(preds, target, filter_length, zero_mean=False, load_diag=None):
    """SDR in float64 through ``scipy.linalg.solve_toeplitz`` (Levinson), row by row."""
    preds, target = np.asarray(preds, np.float64), np.asarray(target, np.float64)
    if zero_mean:
        preds = preds - preds.mean(-1, keepdims=True)
        target = target - target.mean(-1, keepdims=True)
    preds = preds / np.linalg.norm(preds, axis=-1, keepdims=True)
    target = target / np.linalg.norm(target, axis=-1, keepdims=True)
    n_fft = 2 ** int(np.ceil(np.log2(preds.shape[-1] + target.shape[-1] - 1)))
    t_fft = np.fft.rfft(target, n_fft)
    r_0 = np.fft.irfft(np.abs(t_fft) ** 2, n_fft)[..., :filter_length]
    b = np.fft.irfft(np.conj(t_fft) * np.fft.rfft(preds, n_fft), n_fft)[..., :filter_length]
    if load_diag is not None:
        r_0[..., 0] += load_diag
    out = []
    for r_row, b_row in zip(r_0.reshape(-1, filter_length), b.reshape(-1, filter_length)):
        coh = b_row @ solve_toeplitz(r_row, b_row)
        out.append(10 * np.log10(coh / (1 - coh)))
    return np.array(out).reshape(preds.shape[:-1])


# --------------------------------------------------------------- recorded values
def _seeded(*shapes):
    g = torch.Generator().manual_seed(1)
    return [torch.randn(*s, generator=g) for s in shapes]


@pytest.mark.parametrize(
    "name, recorded",
    [("signal_noise_ratio", 16.1805), ("scale_invariant_signal_noise_ratio", 15.0918),
     ("scale_invariant_signal_distortion_ratio", 18.4030)],
)
def test_recorded_values_of_the_closed_forms(name, recorded):
    cls = {"signal_noise_ratio": "SignalNoiseRatio", "scale_invariant_signal_noise_ratio":
           "ScaleInvariantSignalNoiseRatio", "scale_invariant_signal_distortion_ratio":
           "ScaleInvariantSignalDistortionRatio"}[name]
    got = getattr(tF, name)(torch.tensor(PREDS4), torch.tensor(TARGET4))
    want = getattr(jF, name)(jnp.asarray(PREDS4), jnp.asarray(TARGET4))
    assert _dtype(got) == str(want.dtype) and got.shape == want.shape
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    np.testing.assert_allclose(float(got), recorded, atol=1e-4)
    module = getattr(M, cls)(device="cpu")
    np.testing.assert_allclose(float(module(torch.tensor(PREDS4), torch.tensor(TARGET4))), recorded, atol=1e-4)


def test_recorded_sdr_and_pit_rows():
    """The reference's seed-1 doctest draws: SDR -12.0589 (atol 1e-3), then PIT
    over SDR on the next draws."""
    preds, target, pit_preds, pit_target = _seeded((8000,), (8000,), (4, 2, 8000), (4, 2, 8000))
    sdr = tF.signal_distortion_ratio(preds, target)
    np.testing.assert_allclose(float(sdr), -12.0589, atol=1e-3)
    sdr_jax = jF.signal_distortion_ratio(jnp.asarray(preds.numpy()), jnp.asarray(target.numpy()))
    np.testing.assert_allclose(float(sdr), float(sdr_jax), atol=float(_sdr_tol(sdr_jax)))
    metric, perm = tF.permutation_invariant_training(pit_preds, pit_target, tF.signal_distortion_ratio, "max")
    np.testing.assert_allclose(_np(metric), [-11.6375, -11.4358, -11.7148, -11.6325], atol=1e-3)
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(_np(perm), [[1, 0], [0, 1], [1, 0], [0, 1]])
    module = M.PermutationInvariantTraining(tF.signal_distortion_ratio, "max", device="cpu")
    np.testing.assert_allclose(float(module(pit_preds, pit_target)), float(metric.mean()), rtol=RTOL)


def test_recorded_stoi():
    preds, target = _seeded((8000,), (8000,))
    val = tF.short_time_objective_intelligibility(preds, target, 8000)
    assert val.shape == () and val.dtype == torch.float32
    assert abs(float(val) - (-0.0100)) < 5e-5
    want = jF.short_time_objective_intelligibility(jnp.asarray(preds.numpy()), jnp.asarray(target.numpy()), 8000)
    np.testing.assert_allclose(float(val), float(want), atol=STOI_ATOL)
    module = M.ShortTimeObjectiveIntelligibility(8000, False, device="cpu")
    assert abs(float(module(preds, target)) - (-0.0100)) < 5e-5


# ------------------------------------------------------------ SNR, SI-SNR, SI-SDR
@pytest.mark.parametrize("zero_mean", [False, True])
@pytest.mark.parametrize("name", ["signal_noise_ratio", "scale_invariant_signal_distortion_ratio"])
def test_closed_forms_equal_jax_and_float64(name, zero_mean):
    preds, target = _signals(11, (4, 8, 500), 0.3)
    preds = preds + 3.0  # an offset that zero_mean takes away
    got = getattr(tF, name)(_t(preds), _t(target), zero_mean=zero_mean)
    want = getattr(jF, name)(jnp.asarray(preds), jnp.asarray(target), zero_mean=zero_mean)
    assert _dtype(got) == str(want.dtype) and got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL)
    ref = (_np_snr if name == "signal_noise_ratio" else _np_si_sdr)(preds, target, zero_mean)
    np.testing.assert_allclose(_np(got), ref, rtol=F64_RTOL)


def test_si_snr_equals_jax_and_float64():
    preds, target = _signals(12, (8, 1000), 0.2)
    got = tF.scale_invariant_signal_noise_ratio(_t(preds), _t(target))
    np.testing.assert_allclose(
        _np(got), np.asarray(jF.scale_invariant_signal_noise_ratio(jnp.asarray(preds), jnp.asarray(target))), rtol=RTOL
    )
    np.testing.assert_allclose(_np(got), _np_si_sdr(preds, target, zero_mean=True), rtol=F64_RTOL)


# ------------------------------------------------------------------------ SDR
SDR_CASES = [
    {"filter_length": 64},
    {"filter_length": 64, "zero_mean": True},
    {"filter_length": 64, "load_diag": 1e-3},
    {"filter_length": 64, "use_cg_iter": 50},
    {"filter_length": 16},
    {"filter_length": 512},
]


@pytest.mark.parametrize("kwargs", SDR_CASES, ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()))
def test_sdr_equals_jax_and_solve_toeplitz(kwargs):
    preds, target = _signals(9, (2, 3000), 0.25)
    preds = 0.8 * preds + (2.0 if kwargs.get("zero_mean") else 0.0)
    got = tF.signal_distortion_ratio(_t(preds), _t(target), **kwargs)
    want = jF.signal_distortion_ratio(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    assert _dtype(got) == str(want.dtype) == "float32" and got.shape == want.shape
    ref = _np_sdr(preds, target, kwargs["filter_length"], kwargs.get("zero_mean", False), kwargs.get("load_diag"))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=_sdr_tol(ref).max())
    np.testing.assert_allclose(_np(got), ref, rtol=0, atol=_sdr_tol(ref).max())


@pytest.mark.parametrize("noise", [1.0, 0.3, 0.1, 0.03, 0.01])
def test_sdr_tolerance_holds_over_the_sdr_range(noise):
    """0 to 40 dB at the default 512 taps: the float32 solve's error grows as
    1 + 10 ** (SDR / 10), in the port and in the JAX package alike."""
    preds, target = _signals(20, (4, 8000), noise)
    got = _np(tF.signal_distortion_ratio(_t(preds), _t(target)))
    want = np.asarray(jF.signal_distortion_ratio(jnp.asarray(preds), jnp.asarray(target)))
    ref = _np_sdr(preds, target, 512)
    tol = _sdr_tol(ref)
    assert np.all(np.abs(got - ref) <= tol), (got, ref, tol)
    assert np.all(np.abs(got - want) <= tol), (got, want, tol)


def test_sdr_float64_input_takes_the_x64_branch():
    rng = np.random.RandomState(4)
    target = rng.randn(2, 3000)
    preds = 0.8 * target + 0.2 * rng.randn(2, 3000)
    got = tF.signal_distortion_ratio(_t(preds), _t(target), filter_length=64)
    with enable_x64(True):
        want = jF.signal_distortion_ratio(jnp.asarray(preds), jnp.asarray(target), filter_length=64)
        assert str(want.dtype) == "float64"
        want = np.asarray(want)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-9)
    np.testing.assert_allclose(_np(got), _np_sdr(preds, target, 64), rtol=0, atol=1e-9)
    # float32 input: the x64-off branch (float32 out, the zero lag loaded by 1 + 1e-6)
    got32 = tF.signal_distortion_ratio(_t(preds.astype(np.float32)), _t(target.astype(np.float32)), filter_length=64)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(_np(got32), _np(got), rtol=0, atol=_sdr_tol(_np(got)).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_singular_sdr_system_gives_jax_non_finite_value_without_raising(dtype):
    preds = np.random.RandomState(5).randn(2, 1000).astype(dtype)
    target = np.zeros((2, 1000), dtype)
    got = tF.signal_distortion_ratio(_t(preds), _t(target), filter_length=32)
    with enable_x64(dtype == np.float64):
        want = np.asarray(jF.signal_distortion_ratio(jnp.asarray(preds), jnp.asarray(target), filter_length=32))
    assert not np.isfinite(want).any()
    np.testing.assert_array_equal(_np(got), want)  # NaN where NaN


def test_sdr_module_keeps_float32_and_int32_states_for_float64_input():
    preds, target = _signals(6, (2, 2000), 0.2)
    m = M.SignalDistortionRatio(filter_length=64, device="cpu")
    m.update(_t(preds.astype(np.float64)), _t(target.astype(np.float64)))
    assert m.sum_sdr.dtype == torch.float32 and m.total.dtype == torch.int32 and int(m.total) == 2
    assert np.isfinite(float(m.compute()))


# ------------------------------------------------------------------------ PIT
def _pit_both(preds, target, name="scale_invariant_signal_distortion_ratio", eval_func="max", **kwargs):
    got = tF.permutation_invariant_training(_t(preds), _t(target), getattr(tF, name), eval_func, **kwargs)
    want = jF.permutation_invariant_training(jnp.asarray(preds), jnp.asarray(target), getattr(jF, name), eval_func,
                                             **kwargs)
    return got, want


def _same_pit(got, want, rtol=RTOL, atol=0.0):
    assert got[1].dtype == torch.int32 and str(want[1].dtype) == "int32"
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    assert _dtype(got[0]) == str(want[0].dtype) and got[0].shape == want[0].shape
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), rtol=rtol, atol=atol, equal_nan=True)


@pytest.mark.parametrize("spk", [2, 3, 4, 5])
def test_pit_recovers_planted_permutations_like_jax(spk):
    rng = np.random.RandomState(spk)
    target = rng.randn(6, spk, 400).astype(np.float32)
    planted = np.stack([rng.permutation(spk) for _ in range(6)])
    preds = np.take_along_axis(target, planted[:, :, None], axis=1) + 0.05 * rng.randn(6, spk, 400)
    preds = preds.astype(np.float32)
    got, want = _pit_both(preds, target)
    _same_pit(got, want)
    # best_perm[b, j] is the estimate that goes with target j: the inverse of the planted order
    np.testing.assert_array_equal(_np(got[1]), np.argsort(planted, axis=1))
    restored = tF.pit_permutate(_t(preds), got[1])
    np.testing.assert_array_equal(_np(restored), np.asarray(jF.pit_permutate(jnp.asarray(preds), want[1])))
    direct = tF.scale_invariant_signal_distortion_ratio(restored, _t(target)).mean(dim=-1)
    np.testing.assert_allclose(_np(got[0]), _np(direct), rtol=RTOL)


def test_pit_ties_take_the_first_permutation_like_jax():
    """Every speaker estimate the same signal: all permutations tie."""
    rng = np.random.RandomState(7)
    target = rng.randn(3, 3, 200).astype(np.float32)
    preds = np.repeat(rng.randn(3, 1, 200).astype(np.float32), 3, axis=1)
    for eval_func in ("max", "min"):
        got, want = _pit_both(preds, target, eval_func=eval_func)
        _same_pit(got, want)
    np.testing.assert_array_equal(_np(got[1]), np.tile([0, 1, 2], (3, 1)))


@pytest.mark.parametrize("eval_func", ["max", "min"])
def test_pit_nan_entries_pick_the_first_nan_permutation_like_jax(eval_func):
    """``log`` of the dot product: NaN for the pairs whose product is negative.
    The rows with a negated estimate have NaN permutations (the first NaN
    wins), the others are finite."""
    rng = np.random.RandomState(8)
    preds = np.abs(rng.randn(16, 3, 50)).astype(np.float32)
    target = np.abs(rng.randn(16, 3, 50)).astype(np.float32)
    preds[::3, 1] *= -1
    got = tF.permutation_invariant_training(_t(preds), _t(target), lambda p, t: torch.log((p * t).sum(-1)), eval_func)
    want = jF.permutation_invariant_training(jnp.asarray(preds), jnp.asarray(target),
                                             lambda p, t: jnp.log((p * t).sum(-1)), eval_func)
    assert np.isnan(np.asarray(want[0])).any() and np.isfinite(np.asarray(want[0])).any()
    _same_pit(got, want)


def test_pit_min_mode_on_a_loss_like_jax():
    rng = np.random.RandomState(5)
    target = rng.randn(3, 2, 1000).astype(np.float32)
    preds = target[:, ::-1, :].copy()
    got = tF.permutation_invariant_training(
        _t(preds), _t(target), lambda p, t: -tF.scale_invariant_signal_distortion_ratio(p, t), eval_func="min")
    want = jF.permutation_invariant_training(
        jnp.asarray(preds), jnp.asarray(target), lambda p, t: -jF.scale_invariant_signal_distortion_ratio(p, t),
        eval_func="min")
    _same_pit(got, want)
    np.testing.assert_array_equal(_np(tF.pit_permutate(_t(preds), got[1])), target)


def test_pit_exhaustive_search_equals_hungarian():
    rng = np.random.RandomState(1)
    mtx = rng.randn(5, 3, 3).astype(np.float32)
    for maximize in (True, False):
        ex = _find_best_perm_by_exhaustive_method(_t(mtx), maximize)
        hu = _find_best_perm_by_linear_sum_assignment(_t(mtx), maximize)
        jhu = jax_hungarian(jnp.asarray(mtx), maximize)
        for got in (ex, hu):
            np.testing.assert_array_equal(_np(got[1]), np.asarray(jhu[1]))
            np.testing.assert_allclose(_np(got[0]), np.asarray(jhu[0]), rtol=RTOL)


def test_pit_forwards_kwargs_and_permutates_4d_like_jax():
    preds, target = _signals(3, (3, 2, 600), 1.5)
    got, want = _pit_both(preds, target, "signal_distortion_ratio", filter_length=32)
    _same_pit(got, want, rtol=0.0, atol=_sdr_tol(np.asarray(want[0])).max())
    channels = np.random.RandomState(4).randn(3, 2, 4, 50).astype(np.float32)  # (batch, spk, channel, time)
    np.testing.assert_array_equal(_np(tF.pit_permutate(_t(channels), got[1])),
                                  np.asarray(jF.pit_permutate(jnp.asarray(channels), want[1])))


@pytest.mark.parametrize(
    "preds_shape, target_shape, eval_func",
    [((2, 2, 10), (2, 3, 10), "max"), ((2, 2, 10), (2, 2, 10), "best"), ((2,), (2,), "max")],
)
def test_pit_errors_equal_jax(preds_shape, target_shape, eval_func):
    def call(mod, arr, fn):
        return mod.permutation_invariant_training(arr(np.zeros(preds_shape, np.float32)),
                                                  arr(np.zeros(target_shape, np.float32)), fn, eval_func)

    with pytest.raises(Exception) as jax_err:
        call(jF, jnp.asarray, jF.scale_invariant_signal_distortion_ratio)
    with pytest.raises(jax_err.type) as port_err:
        call(tF, _t, tF.scale_invariant_signal_distortion_ratio)
    assert str(port_err.value) == str(jax_err.value)


def test_pit_module_splits_the_base_kwargs_from_metric_func_kwargs():
    m = M.PermutationInvariantTraining(tF.signal_distortion_ratio, "max", device="cpu", jit_update=False,
                                       filter_length=64)
    assert m.kwargs == {"filter_length": 64} and m.device.type == "cpu"


# ----------------------------------------------------------------------- STOI
@pytest.fixture(scope="module")
def stoi_cases():
    """(fs, extended) -> (clean, degraded, JAX value): one second of noise-degraded
    white noise a rate, shared by the tests below."""
    rng = np.random.RandomState(3)
    out = {}
    for fs in (8000, 10000, 16000):
        clean = rng.randn(fs).astype(np.float32)
        degraded = (clean + 0.8 * rng.randn(fs)).astype(np.float32)
        for extended in (False, True):
            want = float(jF.short_time_objective_intelligibility(jnp.asarray(degraded), jnp.asarray(clean), fs,
                                                                 extended))
            out[fs, extended] = (clean, degraded, want)
    return out


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("fs", [8000, 10000, 16000])
def test_stoi_equals_jax_and_the_float64_replica(stoi_cases, fs, extended):
    clean, degraded, want = stoi_cases[fs, extended]
    got = tF.short_time_objective_intelligibility(_t(degraded), _t(clean), fs, extended)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, atol=STOI_ATOL)
    ref = _numpy_stoi(clean.astype(np.float64), degraded.astype(np.float64), fs, extended)
    np.testing.assert_allclose(float(got), ref, atol=STOI_F64_ATOL)


def test_stoi_batches_rows_and_leading_shapes(stoi_cases):
    rows = [stoi_cases[16000, ext] for ext in (False, True)]
    clean = np.stack([r[0] for r in rows] + [rows[0][1]])
    degraded = np.stack([r[1] for r in rows] + [rows[0][0]])
    got = tF.short_time_objective_intelligibility(_t(degraded), _t(clean), 16000)
    assert got.shape == (3,)
    for i in range(3):
        single = tF.short_time_objective_intelligibility(_t(degraded[i]), _t(clean[i]), 16000)
        np.testing.assert_allclose(float(got[i]), float(single), atol=STOI_ATOL)
    np.testing.assert_allclose(float(got[0]), stoi_cases[16000, False][2], atol=STOI_ATOL)
    md = tF.short_time_objective_intelligibility(_t(degraded.reshape(3, 1, -1)), _t(clean.reshape(3, 1, -1)), 16000)
    assert md.shape == (3, 1)
    np.testing.assert_array_equal(_np(md).reshape(-1), _np(got))


def test_stoi_compaction_is_jax_bits():
    """Silent gaps in the clean signal: the frames kept, their count and the
    rebuilt signals equal the JAX package's bit for bit."""
    rng = np.random.RandomState(2)
    clean = rng.randn(12000).astype(np.float32)
    clean[3000:5000] = 0.0
    clean[8000:8600] *= 1e-3
    noisy = (clean + 0.1 * rng.randn(12000)).astype(np.float32)
    x, y, k = port_stoi._compact_loud_frames(_t(clean[None]), _t(noisy[None]), 256, 128)
    jx, jy, jk = jax_stoi._compact_loud_frames(jnp.asarray(clean), jnp.asarray(noisy), 256, 128)
    assert int(k[0]) == int(jk) < (12000 - 256) // 128
    np.testing.assert_array_equal(_np(x[0]), np.asarray(jx))
    np.testing.assert_array_equal(_np(y[0]), np.asarray(jy))


def test_stoi_invariants_as_in_jax():
    """Padding the clean signal with silence leaves the score (within 2e-2, the
    JAX test's bound), a signal against itself scores 1, and a signal too short
    for one segment gives pystoi's 1e-5."""
    rng = np.random.RandomState(2)
    clean = rng.randn(12000).astype(np.float32)
    noisy = (clean + 0.7 * rng.randn(12000)).astype(np.float32)
    pad = np.zeros(4096, np.float32)
    base = float(tF.short_time_objective_intelligibility(_t(noisy), _t(clean), 10000))
    padded = float(tF.short_time_objective_intelligibility(_t(np.concatenate([pad, noisy, pad])),
                                                           _t(np.concatenate([pad, clean, pad])), 10000))
    np.testing.assert_allclose(padded, base, atol=2e-2)
    np.testing.assert_allclose(float(tF.short_time_objective_intelligibility(_t(clean), _t(clean), 10000)), 1.0,
                               atol=1e-4)
    short = _t(rng.randn(2000).astype(np.float32))
    assert float(tF.short_time_objective_intelligibility(short, short, 10000)) == np.float32(1e-5)
    ext = float(tF.short_time_objective_intelligibility(_t(noisy), _t(clean), 10000, True))
    assert ext != base


# ----------------------------------------------------------------------- PESQ
CORPUS = build_corpus()


@pytest.mark.parametrize("case", CORPUS, ids=[c["id"] for c in CORPUS])
def test_pesq_native_is_jax_bits_on_the_corpus(case):
    args = (case["fs"], case["mode"])
    got = tF.perceptual_evaluation_speech_quality(_t(case["degraded"]), _t(case["target"]), *args, backend="native")
    want = jF.perceptual_evaluation_speech_quality(jnp.asarray(case["degraded"]), jnp.asarray(case["target"]), *args,
                                                   backend="native")
    assert got.dtype == torch.float32 and got.device.type == "cpu" and got.shape == ()
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_pesq_module_is_jax_bits():
    cases = [c for c in CORPUS if c["mode"] == "wb"][:4]
    preds = np.stack([c["degraded"] for c in cases]).astype(np.float32)
    target = np.stack([c["target"] for c in cases]).astype(np.float32)
    jm = J.PerceptualEvaluationSpeechQuality(16000, "wb", backend="native")
    tm = M.PerceptualEvaluationSpeechQuality(16000, "wb", backend="native", device="cpu")
    for sl in (slice(0, 3), slice(3, 4)):
        jm.update(jnp.asarray(preds[sl]), jnp.asarray(target[sl]))
        tm.update(_t(preds[sl]), _t(target[sl]))
    assert tm.sum_pesq.dtype == torch.float32 and tm.total.dtype == torch.int32
    np.testing.assert_array_equal(_np(tm.sum_pesq), np.asarray(jm.sum_pesq))
    assert int(tm.total) == int(jm.total) == 4
    np.testing.assert_array_equal(_np(tm.compute()), np.asarray(jm.compute()))


def test_pesq_backend_pesq_raises_where_the_package_is_absent(monkeypatch):
    import metrics_tpu.audio.pesq  # noqa: F401 -- the JAX module reads its flag from metrics_tpu.utilities.imports
    import metrics_tpu.functional.audio.pesq as jax_fn
    import metrics_tpu.utilities.imports as jax_imports
    import metrics_tpu_torch.audio.pesq as port_mod
    import metrics_tpu_torch.functional.audio.pesq as port_fn

    monkeypatch.setattr(jax_imports, "_PESQ_AVAILABLE", False)
    monkeypatch.setattr(jax_fn, "_PESQ_AVAILABLE", False)
    monkeypatch.setattr(port_mod, "_PESQ_AVAILABLE", False)
    monkeypatch.setattr(port_fn, "_PESQ_AVAILABLE", False)
    with pytest.raises(ModuleNotFoundError) as jax_err:
        J.PerceptualEvaluationSpeechQuality(16000, "wb", backend="pesq")
    with pytest.raises(ModuleNotFoundError) as port_err:
        M.PerceptualEvaluationSpeechQuality(16000, "wb", backend="pesq", device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    sig = np.random.RandomState(0).randn(8000).astype(np.float32)
    with pytest.raises(ModuleNotFoundError) as jax_err:
        jF.perceptual_evaluation_speech_quality(jnp.asarray(sig), jnp.asarray(sig), 8000, "nb", backend="pesq")
    with pytest.raises(ModuleNotFoundError) as port_err:
        tF.perceptual_evaluation_speech_quality(_t(sig), _t(sig), 8000, "nb", backend="pesq")
    assert str(port_err.value) == str(jax_err.value)


def test_pesq_auto_warns_once_and_scores_natively(monkeypatch):
    import metrics_tpu_torch.functional.audio.pesq as port_fn

    monkeypatch.setattr(port_fn, "_PESQ_AVAILABLE", False)
    monkeypatch.setattr(port_fn, "_warned_native", False)
    sig = np.random.RandomState(1).randn(2, 8000).astype(np.float32)
    noisy = sig + 0.3 * np.random.RandomState(2).randn(2, 8000).astype(np.float32)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        auto = tF.perceptual_evaluation_speech_quality(_t(noisy), _t(sig), 8000, "nb")
        tF.perceptual_evaluation_speech_quality(_t(noisy), _t(sig), 8000, "nb")
    native = [w for w in caught if "backend='native'" in str(w.message)]
    assert len(native) == 1 and native[0].category is UserWarning
    assert str(native[0].message).startswith("The `pesq` package is not installed")
    np.testing.assert_array_equal(
        _np(auto), _np(tF.perceptual_evaluation_speech_quality(_t(noisy), _t(sig), 8000, "nb", backend="native")))


@pytest.fixture()
def pesq_stub(monkeypatch):
    """A stand-in ``pesq`` package whose score is a deterministic function of
    the inputs, in both packages; records every call."""
    calls = []

    def fake_pesq(fs, target, preds, mode):
        calls.append((fs, mode, np.asarray(target).shape, np.asarray(preds).dtype))
        return float(2.0 + 0.5 * np.sign(np.sum(preds) - np.sum(target)))

    module = types.ModuleType("pesq")
    module.pesq = fake_pesq
    monkeypatch.setitem(sys.modules, "pesq", module)
    import metrics_tpu.functional.audio.pesq as jax_fn
    import metrics_tpu_torch.functional.audio.pesq as port_fn

    monkeypatch.setattr(jax_fn, "_PESQ_AVAILABLE", True)
    monkeypatch.setattr(port_fn, "_PESQ_AVAILABLE", True)
    return calls


def test_pesq_package_backend_flattens_batches_like_jax(pesq_stub):
    rng = np.random.RandomState(0)
    preds = rng.rand(2, 3, 800).astype(np.float32)
    target = rng.rand(2, 3, 800).astype(np.float32)
    jm = J.PerceptualEvaluationSpeechQuality(16000, "wb")
    tm = M.PerceptualEvaluationSpeechQuality(16000, "wb", device="cpu")
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    jax_calls = list(pesq_stub)
    del pesq_stub[:]
    tm.update(_t(preds), _t(target))
    assert pesq_stub == jax_calls and len(pesq_stub) == 6
    np.testing.assert_array_equal(_np(tm.compute()), np.asarray(jm.compute()))


@pytest.mark.parametrize("kwargs", [{"fs": 44100, "mode": "wb"}, {"fs": 16000, "mode": "ultra"},
                                    {"fs": 16000, "mode": "wb", "backend": "fast"}])
def test_pesq_argument_errors_equal_jax(kwargs):
    with pytest.raises(ValueError) as jax_err:
        J.PerceptualEvaluationSpeechQuality(**kwargs)
    with pytest.raises(ValueError) as port_err:
        M.PerceptualEvaluationSpeechQuality(**kwargs, device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    sig = np.zeros(800, np.float32)
    with pytest.raises(ValueError) as jax_err:
        jF.perceptual_evaluation_speech_quality(jnp.asarray(sig), jnp.asarray(sig), **kwargs)
    with pytest.raises(ValueError) as port_err:
        tF.perceptual_evaluation_speech_quality(_t(sig), _t(sig), **kwargs)
    assert str(port_err.value) == str(jax_err.value)


def test_host_only_metric_warns_runs_eagerly_and_the_engine_refuses_it():
    sig = np.random.RandomState(3).randn(8000).astype(np.float32)
    noisy = sig + 0.2 * np.random.RandomState(4).randn(8000).astype(np.float32)
    assert M.PerceptualEvaluationSpeechQuality.host_only is True and M.SignalNoiseRatio.host_only is False
    with pytest.warns(UserWarning, match="host_only") as jax_warned:
        jm = J.PerceptualEvaluationSpeechQuality(8000, "nb", backend="native", jit_update=True)
    with pytest.warns(UserWarning, match="host_only") as port_warned:
        tm = M.PerceptualEvaluationSpeechQuality(8000, "nb", backend="native", jit_update=True, device="cpu")
    assert [str(w.message) for w in port_warned] == [str(w.message) for w in jax_warned]
    jm.update(jnp.asarray(noisy), jnp.asarray(sig))
    tm.update(_t(noisy), _t(sig))
    np.testing.assert_array_equal(_np(tm.compute()), np.asarray(jm.compute()))
    assert tm.dispatch_stats["dispatches"] == 1 and tm._dispatcher is None
    with pytest.raises(JaxUnsupported) as jax_err:
        jm._make_dispatcher()._prepare_call((), (), ())
    with pytest.raises(FastDispatchUnsupported) as port_err:
        tm._make_dispatcher().update({}, (), (_t(noisy), _t(sig)), {})
    assert str(port_err.value) == str(jax_err.value)


# -------------------------------------------------------------------- modules
def _modules(pkg, device=None):
    """The seven module metrics, built alike in both packages."""
    extra = {} if device is None else {"device": device}
    fn = tF if device is not None else jF
    return {
        "SignalNoiseRatio": pkg.SignalNoiseRatio(zero_mean=True, **extra),
        "ScaleInvariantSignalNoiseRatio": pkg.ScaleInvariantSignalNoiseRatio(**extra),
        "SignalDistortionRatio": pkg.SignalDistortionRatio(filter_length=64, **extra),
        "ScaleInvariantSignalDistortionRatio": pkg.ScaleInvariantSignalDistortionRatio(**extra),
        "PermutationInvariantTraining": pkg.PermutationInvariantTraining(
            fn.scale_invariant_signal_distortion_ratio, "max", **extra),
        "ShortTimeObjectiveIntelligibility": pkg.ShortTimeObjectiveIntelligibility(8000, **extra),
        "PerceptualEvaluationSpeechQuality": pkg.PerceptualEvaluationSpeechQuality(8000, "nb", backend="native",
                                                                                   **extra),
    }


MODULES = list(_modules(M, "cpu"))
# (batch, speakers, time) for PIT; (batch, time) for the rest
_BATCH_SHAPE = {"PermutationInvariantTraining": (2, 2, 8000)}


def _batches(name, n, seed=30):
    shape = _BATCH_SHAPE.get(name, (2, 8000))
    return [_signals(seed + i, shape, 0.4) for i in range(n)]


def _same_state(tm, jm):
    for key in tm._defaults:
        got, want = getattr(tm, key), np.asarray(getattr(jm, key))
        assert _dtype(got) == str(want.dtype), (key, got.dtype, want.dtype)
        if want.dtype.kind == "i":
            np.testing.assert_array_equal(_np(got), want)
        else:
            np.testing.assert_allclose(_np(got), want, rtol=SUM_RTOL, atol=1e-5)


@pytest.mark.parametrize("name", MODULES)
def test_module_update_forward_compute_reset_equal_jax(name):
    jm, tm = _modules(J)[name], _modules(M, "cpu")[name]
    (p0, t0), (p1, t1) = _batches(name, 2)
    jm.update(jnp.asarray(p0), jnp.asarray(t0))
    tm.update(_t(p0), _t(t0))
    _same_state(tm, jm)
    fwd_j, fwd_t = jm(jnp.asarray(p1), jnp.asarray(t1)), tm(_t(p1), _t(t1))
    np.testing.assert_allclose(_np(fwd_t), np.asarray(fwd_j), rtol=SUM_RTOL, atol=1e-5)
    _same_state(tm, jm)
    value = tm.compute()
    assert value.dtype == torch.float32 and value.shape == ()
    np.testing.assert_allclose(_np(value), np.asarray(jm.compute()), rtol=SUM_RTOL, atol=1e-5)
    tm.reset()
    assert float(tm.total) == 0 and float(next(iter(v for k, v in tm.state().items() if k != "total"))) == 0.0


@pytest.mark.parametrize("name", MODULES)
def test_module_checkpoints_cross_between_jax_and_port(name):
    """JAX -> port -> JAX, then one more batch in all three: the same states."""
    jm, tm, back = _modules(J)[name], _modules(M, "cpu")[name], _modules(J)[name]
    for m in (jm, tm, back):
        m.persistent(True)
    (p0, t0), (p1, t1) = _batches(name, 2, seed=40)
    jm.update(jnp.asarray(p0), jnp.asarray(t0))
    load_jax_state_dict(tm, jm.state_dict())
    _same_state(tm, jm)
    back.load_state_dict(to_jax_state_dict(tm))
    for m in (jm, back):
        m.update(jnp.asarray(p1), jnp.asarray(t1))
    tm.update(_t(p1), _t(t1))
    _same_state(tm, jm)
    _same_state(tm, back)


def _ctor_kwargs(name):
    return {
        "SignalNoiseRatio": {"zero_mean": True},
        "ScaleInvariantSignalNoiseRatio": {},
        "SignalDistortionRatio": {"filter_length": 64},
        "ScaleInvariantSignalDistortionRatio": {},
        "PermutationInvariantTraining": {"metric_func": tF.scale_invariant_signal_distortion_ratio},
        "ShortTimeObjectiveIntelligibility": {"fs": 8000},
    }[name]


@pytest.mark.parametrize("name", [n for n in MODULES if n != "PerceptualEvaluationSpeechQuality"])
def test_module_engine_state_is_the_eager_bits(name):
    """``jit_update=True`` on the CPU: the engine's states equal the eager
    update's bit for bit, one program a shape."""
    eager = _modules(M, "cpu")[name]
    engine = type(eager)(**{**_ctor_kwargs(name), "jit_update": True, "device": "cpu"})
    for p, t in _batches(name, 3, seed=50):
        eager.update(_t(p), _t(t))
        engine.update(_t(p), _t(t))
    for key in eager._defaults:
        assert torch.equal(getattr(engine, key), getattr(eager, key)), key
    assert engine.dispatch_stats["dispatches"] == 3 and engine.dispatch_stats["retraces"] == 1
