"""The port's image metrics without a net held against the JAX package on the CPU.

Built from the cases of ``tests/image/test_image.py``, ``test_image_params.py``,
``test_ssim_oracle.py`` and ``test_image_recorded_oracles.py``: the eight
functionals over every parameter those files exercise, their errors, the
seven modules through ``update``, ``forward``, ``compute`` and ``reset``,
bfloat16 inputs and the recorded values. The same seeded numpy images go
through ``metrics_tpu`` and ``metrics_tpu_torch``: textured (a smooth field
of a few sines, half its range seeded noise) with a noisy copy as the
prediction. Tolerances:

* exact: integer states, the list states' images, ``image_gradients``,
  value dtypes and shapes;
* SSIM, MS-SSIM and UQI: atol 1e-5 on a value an image or a mean, 1e-4 on
  a full map (the window variances ``E[x²] - μ²`` cancel in float32, and the
  two packages' convolutions add their 121 taps in other orders);
* SAM: atol 1e-3 (``arccos`` amplifies the cosine's last bit near 0);
* PSNR and ERGAS: rtol 1e-5; D-lambda: rtol 1e-5 and atol 1e-6 (a mean of
  differences of two UQI values, each as close as UQI's, so its error is
  absolute: 1.8e-7 on a value of 0.0135 at p = 2 is rtol 1.3e-5);
* bfloat16: the JAX package's dtype, and the value within the JAX package's
  own bfloat16 bounds (``tests/bases/test_precision_bf16.py``: half a dB for
  PSNR, 5e-2 for SSIM) of both the JAX package's bfloat16 value and the
  port's float32 value.

NaN must stand where the JAX package's NaN stands.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu.functional as jF
import metrics_tpu_torch as M
import metrics_tpu_torch.functional as tF

SCALAR_ATOL, MAP_ATOL, SAM_ATOL, RTOL = 1e-5, 1e-4, 1e-3, 1e-5
MS_BETAS = (0.3, 0.4, 0.3)
D_LAMBDA = {"rtol": RTOL, "atol": 1e-6}
# the one shape of most 2-D cases: the JAX package compiles each of its operations once a shape
IMAGES = (2, 2, 24, 24)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, dtype=np.float32)


def _dtype(x):
    return str(x.dtype).replace("torch.", "")


def _close(ref, got, atol=0.0, rtol=0.0):
    """Port value ``got`` against JAX value ``ref`` (tuples element by element):
    dtype and shape exact, the values within the tolerance, NaN where NaN."""
    if isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(got) == len(ref)
        for a, b in zip(ref, got):
            _close(a, b, atol, rtol)
        return
    assert _dtype(got) == str(ref.dtype), (_dtype(got), ref.dtype)
    assert tuple(got.shape) == tuple(ref.shape), (tuple(got.shape), ref.shape)
    if atol == 0.0 and rtol == 0.0:
        np.testing.assert_array_equal(_np(got), _np(ref))
    else:
        np.testing.assert_allclose(_np(got), _np(ref), atol=atol, rtol=rtol, equal_nan=True)


def _tol(cls):
    """A module's value tolerance: the windowed ones atol 1e-5, SAM 1e-3,
    D-lambda rtol 1e-5 and atol 1e-6, the rest rtol 1e-5."""
    if cls in ("StructuralSimilarityIndexMeasure", "MultiScaleStructuralSimilarityIndexMeasure",
               "UniversalImageQualityIndex"):
        return {"atol": SCALAR_ATOL}
    if cls == "SpectralAngleMapper":
        return {"atol": SAM_ATOL}
    return D_LAMBDA if cls == "SpectralDistortionIndex" else {"rtol": RTOL}


def _same_error(jax_call, torch_call, kind=Exception):
    with pytest.raises(kind) as jax_err:
        jax_call()
    with pytest.raises(kind) as torch_err:
        torch_call()
    assert type(torch_err.value) is type(jax_err.value)
    assert str(torch_err.value) == str(jax_err.value)


def images(seed, shape, noise=0.05):
    """``(preds, target)`` float32: the target a smooth field (four sines of
    seeded frequency and phase) over half its range plus seeded noise over
    the other half, the prediction the target plus gaussian noise, clipped
    to [0, 1]."""
    rng = np.random.RandomState(seed)
    b, c, *spatial = shape
    grids = np.meshgrid(*[np.linspace(0.0, 1.0, n) for n in spatial], indexing="ij")
    field = np.zeros(shape)
    for _ in range(4):
        freq = rng.uniform(0.5, 4.0, len(spatial))
        phase = rng.uniform(0.0, 2 * np.pi, (b, c) + (1,) * len(spatial))
        field += np.sin(2 * np.pi * sum(f * g for f, g in zip(freq, grids)) + phase)
    target = 0.5 * (field - field.min()) / (field.max() - field.min()) + 0.5 * rng.rand(*shape)
    preds = np.clip(target + noise * rng.randn(*shape), 0.0, 1.0)
    return preds.astype(np.float32), target.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jitted(fn, kwargs):
    return jax.jit(functools.partial(getattr(jF, fn), **dict(kwargs)))


def _both(fn, preds, target, jit=False, **kwargs):
    """The JAX functional and the port's on the same images. With ``jit`` the
    JAX one runs under ``jax.jit`` (its keyword arguments static, as the
    Python values they are in the functional): one compile a case instead of
    one an operation and shape, which pays for MS-SSIM's five scales."""
    jax_fn = _jitted(fn, tuple(sorted(kwargs.items()))) if jit else functools.partial(getattr(jF, fn), **kwargs)
    ref = jax_fn(jnp.asarray(preds), jnp.asarray(target))
    got = getattr(tF, fn)(_t(preds), _t(target), **kwargs)
    return ref, got


# ------------------------------------------------------------------- PSNR
@pytest.mark.parametrize("base", [10.0, math.e, 2])
@pytest.mark.parametrize("data_range,dim,reduction", [
    (None, None, "elementwise_mean"),
    (1.0, None, "elementwise_mean"),
    (255, None, "elementwise_mean"),
    (1.0, (1, 2, 3), "none"),
    (1.0, (1, 2, 3), "elementwise_mean"),
    (1.0, (1, 2, 3), "sum"),
    (1.0, 1, "none"),
    (1.0, (2, 3), "none"),
    (2.0, (), "none"),
])
def test_psnr_functional_equals_jax(data_range, dim, reduction, base):
    preds, target = images(0, IMAGES)
    _close(*_both("peak_signal_noise_ratio", preds, target, data_range=data_range, base=base, dim=dim,
                  reduction=reduction), rtol=RTOL)


def test_psnr_against_numpy_and_the_recorded_value():
    preds, target = images(1, (4, 3, 32, 32))
    mse = np.mean((preds.astype(np.float64) - target.astype(np.float64)) ** 2)
    got = tF.peak_signal_noise_ratio(_t(preds), _t(target), data_range=1.0)
    np.testing.assert_allclose(float(got), 10 * np.log10(1.0 / mse), rtol=RTOL)
    pred, target = torch.tensor([[0.0, 1.0], [2.0, 3.0]]), torch.tensor([[3.0, 2.0], [1.0, 0.0]])
    np.testing.assert_allclose(float(tF.peak_signal_noise_ratio(pred, target)), 2.5527, atol=1e-4)


def test_psnr_errors_and_warning_equal_jax():
    preds, target = images(2, IMAGES)
    _same_error(lambda: jF.peak_signal_noise_ratio(jnp.asarray(preds), jnp.asarray(target), dim=1),
                lambda: tF.peak_signal_noise_ratio(_t(preds), _t(target), dim=1), ValueError)
    _same_error(lambda: J.PeakSignalNoiseRatio(dim=1), lambda: M.PeakSignalNoiseRatio(dim=1, device="cpu"), ValueError)
    for make in (lambda: jF.peak_signal_noise_ratio(jnp.asarray(preds), jnp.asarray(target), reduction="sum"),
                 lambda: tF.peak_signal_noise_ratio(_t(preds), _t(target), reduction="sum"),
                 lambda: M.PeakSignalNoiseRatio(reduction="none", device="cpu")):
        with pytest.warns(UserWarning, match="will not have any effect when `dim` is None"):
            make()


# ------------------------------------------------------------------- SSIM
SSIM_CASES = {
    "default": {},
    "sigma 0.8": {"sigma": 0.8},
    "sigma 1.0": {"sigma": 1.0},
    "sigma 2.0": {"sigma": 2.0},
    "uniform 7": {"gaussian_kernel": False, "kernel_size": 7},
    "uniform 9": {"gaussian_kernel": False, "kernel_size": 9},
    "uniform 11": {"gaussian_kernel": False, "kernel_size": 11},
    "k 0.05 0.1": {"k1": 0.05, "k2": 0.1},
    "data_range 1": {"data_range": 1.0},
    "data_range 2": {"data_range": 2},
    "sum": {"reduction": "sum"},
    "none": {"reduction": "none"},
    "contrast sensitivity": {"return_contrast_sensitivity": True},
    "contrast sensitivity none": {"return_contrast_sensitivity": True, "reduction": "none"},
}


@pytest.mark.parametrize("case", sorted(SSIM_CASES))
def test_ssim_functional_equals_jax(case):
    preds, target = images(3, IMAGES)
    _close(*_both("structural_similarity_index_measure", preds, target, **SSIM_CASES[case]), atol=SCALAR_ATOL)


@pytest.mark.parametrize("reduction", ["none", "elementwise_mean", "sum"])
def test_ssim_full_image_equals_jax(reduction):
    preds, target = images(4, IMAGES)
    (ref_score, ref_map), (score, full) = _both("structural_similarity_index_measure", preds, target,
                                                return_full_image=True, reduction=reduction)
    _close(ref_score, score, atol=SCALAR_ATOL)
    _close(ref_map, full, atol=MAP_ATOL * (24 * 24 * 4 if reduction == "sum" else 1))


@pytest.mark.parametrize("kwargs", [{"sigma": 1.0}, {"sigma": (1.0, 1.0, 0.8), "reduction": "none"},
                                    {"gaussian_kernel": False, "kernel_size": (5, 3, 5)},
                                    {"sigma": 1.0, "return_contrast_sensitivity": True, "reduction": "none"}],
                         ids=["gaussian", "gaussian anisotropic", "uniform", "contrast sensitivity"])
def test_ssim_3d_equals_jax(kwargs):
    preds, target = images(5, (2, 1, 16, 16, 16))
    _close(*_both("structural_similarity_index_measure", preds, target, **kwargs), atol=SCALAR_ATOL)


def _np_gaussian(kernel_size, sigma):
    kernel = None
    for ks, sg in zip(kernel_size, sigma):
        x = np.arange(ks, dtype=np.float64) - (ks - 1) / 2
        g = np.exp(-(x**2) / (2 * sg**2))
        kernel = g / g.sum() if kernel is None else np.multiply.outer(kernel, g / g.sum())
    return kernel


def _np_windowed(preds, target, kernel, c1=None, c2=None):
    """Per-image float64 SSIM (or UQI where ``c1`` and ``c2`` are None):
    reflect-pad, valid correlation, crop ``slice(p, s - p)``, mean."""
    def correlate(x, k):
        return np.tensordot(np.lib.stride_tricks.sliding_window_view(x, k.shape), k, axes=k.ndim)

    pads = [(k - 1) // 2 for k in kernel.shape]
    out = []
    for b in range(preds.shape[0]):
        maps = []
        for c in range(preds.shape[1]):
            p = np.pad(preds[b, c].astype(np.float64), [(d, d) for d in pads], mode="reflect")
            t = np.pad(target[b, c].astype(np.float64), [(d, d) for d in pads], mode="reflect")
            mu_p, mu_t = correlate(p, kernel), correlate(t, kernel)
            s_pp = correlate(p * p, kernel) - mu_p**2
            s_tt = correlate(t * t, kernel) - mu_t**2
            s_pt = correlate(p * t, kernel) - mu_p * mu_t
            if c1 is None:
                m = (4 * mu_p * mu_t * s_pt) / ((mu_p**2 + mu_t**2) * (s_pp + s_tt))
            else:
                m = ((2 * mu_p * mu_t + c1) * (2 * s_pt + c2)) / ((mu_p**2 + mu_t**2 + c1) * (s_pp + s_tt + c2))
            maps.append(m[tuple(slice(d, n - d) for d, n in zip(pads, m.shape))])
        out.append(np.mean(maps))
    return np.asarray(out)


@pytest.mark.parametrize("sigma", [0.8, 1.5])
def test_ssim_against_float64_numpy(sigma):
    preds, target = images(6, IMAGES)
    ks = 2 * int(3.5 * sigma + 0.5) + 1
    ref = _np_windowed(preds, target, _np_gaussian((ks, ks), (sigma, sigma)), c1=1e-4, c2=9e-4)
    got = tF.structural_similarity_index_measure(_t(preds), _t(target), sigma=sigma, data_range=1.0,
                                                 reduction="none")
    np.testing.assert_allclose(_np(got), ref, atol=SCALAR_ATOL)


def test_ssim_identical_images_and_recorded_value():
    preds, _ = images(7, (2, 1, 16, 16))
    assert float(tF.structural_similarity_index_measure(_t(preds), _t(preds), data_range=1.0)) == pytest.approx(
        1.0, abs=1e-6)
    seeded = torch.rand([16, 1, 16, 16], generator=torch.manual_seed(42))
    np.testing.assert_allclose(float(tF.structural_similarity_index_measure(seeded, seeded * 0.75)), 0.9219,
                               atol=1e-4)


SSIM_ERRORS = {
    "dtype": (np.float32, np.float16, (2, 1, 16, 16), {}, TypeError),
    "shape": (np.float32, np.float32, None, {}, RuntimeError),
    "ndim": (np.float32, np.float32, (2, 16, 16), {}, ValueError),
    "kernel_size dims": (np.float32, np.float32, (2, 1, 16, 16), {"kernel_size": (11, 11, 11)}, ValueError),
    "sigma dims": (np.float32, np.float32, (2, 1, 16, 16), {"sigma": (1.5, 1.5, 1.5)}, ValueError),
    "even kernel": (np.float32, np.float32, (2, 1, 16, 16), {"gaussian_kernel": False, "kernel_size": 4}, ValueError),
    "negative sigma": (np.float32, np.float32, (2, 1, 16, 16), {"sigma": -1.0}, ValueError),
    "window past the image": (np.float32, np.float32, (2, 1, 8, 8), {}, ValueError),
}


@pytest.mark.parametrize("case", sorted(SSIM_ERRORS))
def test_ssim_errors_equal_jax(case):
    p_dtype, t_dtype, shape, kwargs, kind = SSIM_ERRORS[case]
    rng = np.random.RandomState(8)
    preds = rng.rand(*(shape or (2, 1, 16, 16))).astype(p_dtype)
    target = rng.rand(*(shape or (2, 1, 16, 17))).astype(t_dtype)
    _same_error(lambda: jF.structural_similarity_index_measure(jnp.asarray(preds), jnp.asarray(target), **kwargs),
                lambda: tF.structural_similarity_index_measure(_t(preds), _t(target), **kwargs), kind)
    jm, tm = J.StructuralSimilarityIndexMeasure(**kwargs), M.StructuralSimilarityIndexMeasure(**kwargs, device="cpu")
    if kind is not ValueError or case == "ndim":  # the update checks dtypes and shapes; compute the windows
        _same_error(lambda: jm.update(jnp.asarray(preds), jnp.asarray(target)),
                    lambda: tm.update(_t(preds), _t(target)), kind)


# ---------------------------------------------------------------- MS-SSIM
MS_SSIM_CASES = {
    "default 176": ((1, 1, 176, 176), {}),
    "5px relu": ((2, 1, 32, 32), {"kernel_size": 5, "sigma": 0.5, "betas": MS_BETAS}),
    "5px simple": ((2, 1, 32, 32), {"kernel_size": 5, "sigma": 0.5, "betas": MS_BETAS, "normalize": "simple"}),
    "5px none": ((2, 1, 32, 32), {"kernel_size": 5, "sigma": 0.5, "betas": MS_BETAS, "normalize": None}),
    "5px none per image": ((2, 1, 32, 32), {"kernel_size": 5, "sigma": 0.5, "betas": MS_BETAS, "normalize": None,
                                            "reduction": "none"}),
    "5px relu sum": ((2, 1, 32, 32), {"kernel_size": 5, "sigma": 0.5, "betas": MS_BETAS, "reduction": "sum"}),
    "uniform window": ((2, 1, 32, 32), {"gaussian_kernel": False, "kernel_size": 5, "betas": MS_BETAS,
                                        "data_range": 1.0}),
    "k 0.05 0.1": ((2, 1, 32, 32), {"kernel_size": 5, "sigma": 0.5, "betas": MS_BETAS, "k1": 0.05, "k2": 0.1}),
    "3-D two betas": ((1, 1, 16, 16, 16), {"kernel_size": 5, "sigma": 0.5, "betas": (0.5, 0.5)}),
}


@pytest.mark.parametrize("case", sorted(MS_SSIM_CASES))
def test_ms_ssim_functional_equals_jax(case):
    """The JAX package's tests run five betas on 96 px (and the default window
    on 176 px); three betas on 32 px take the same code at a ninth of the
    compile time."""
    shape, kwargs = MS_SSIM_CASES[case]
    preds, target = images(9, shape)
    _close(*_both("multiscale_structural_similarity_index_measure", preds, target, jit=True, **kwargs),
           atol=SCALAR_ATOL)


def test_ms_ssim_negative_scale_gives_nan_where_jax_does():
    """``normalize=None`` keeps a negative scale's SSIM, and its power of a
    fractional beta is NaN in both packages."""
    preds, _ = images(10, (2, 1, 32, 32))
    target = 1.0 - preds  # anti-correlated: negative SSIM at every scale
    ref, got = _both("multiscale_structural_similarity_index_measure", preds, target, jit=True, kernel_size=5,
                     sigma=0.5, betas=MS_BETAS, normalize=None, reduction="none")
    assert np.isnan(np.asarray(ref)).all()
    _close(ref, got, atol=SCALAR_ATOL)


def test_ms_ssim_identical_and_recorded_values():
    preds, _ = images(11, (2, 1, 96, 96))
    np.testing.assert_allclose(float(M.MultiScaleStructuralSimilarityIndexMeasure(kernel_size=5, sigma=0.5,
                                                                                   device="cpu")(_t(preds), _t(preds))),
                               1.0, atol=1e-5)
    with pytest.raises(ValueError, match="effective SSIM window"):
        tF.multiscale_structural_similarity_index_measure(_t(preds), _t(preds), kernel_size=5)
    seeded = torch.rand([1, 1, 176, 176], generator=torch.manual_seed(42))
    np.testing.assert_allclose(float(tF.multiscale_structural_similarity_index_measure(seeded, seeded * 0.75)),
                               0.95569, atol=1e-4)


MS_SSIM_ERRORS = {
    "betas list": ((1, 1, 32, 32), {"betas": [0.5, 0.5]}),
    "betas ints": ((1, 1, 32, 32), {"betas": (1, 2)}),
    "normalize": ((1, 1, 32, 32), {"normalize": "max"}),
    "too small": ((1, 1, 16, 16), {}),
    "height": ((1, 1, 64, 200), {}),
    "width": ((1, 1, 200, 64), {}),
    "window past the coarsest scale": ((1, 1, 16, 16), {"kernel_size": 3, "betas": MS_BETAS}),
}


@pytest.mark.parametrize("case", sorted(MS_SSIM_ERRORS))
def test_ms_ssim_errors_equal_jax(case):
    shape, kwargs = MS_SSIM_ERRORS[case]
    preds = np.random.RandomState(12).rand(*shape).astype(np.float32)
    _same_error(
        lambda: jF.multiscale_structural_similarity_index_measure(jnp.asarray(preds), jnp.asarray(preds), **kwargs),
        lambda: tF.multiscale_structural_similarity_index_measure(_t(preds), _t(preds), **kwargs), ValueError)
    if case.startswith(("betas", "normalize")):
        _same_error(lambda: J.MultiScaleStructuralSimilarityIndexMeasure(**kwargs),
                    lambda: M.MultiScaleStructuralSimilarityIndexMeasure(**kwargs, device="cpu"), ValueError)
    _same_error(lambda: J.MultiScaleStructuralSimilarityIndexMeasure(kernel_size=1.5),
                lambda: M.MultiScaleStructuralSimilarityIndexMeasure(kernel_size=1.5, device="cpu"), ValueError)


# -------------------------------------------------------------------- UQI
UQI_CASES = {
    "default": {},
    "5 x 5": {"kernel_size": (5, 5)},
    "7 x 3": {"kernel_size": (7, 3), "sigma": (1.0, 2.0)},
    "sigma 0.8": {"sigma": (0.8, 0.8)},
    "sum": {"reduction": "sum"},
    "data_range ignored": {"data_range": 3.0},
}


@pytest.mark.parametrize("case", sorted(UQI_CASES))
def test_uqi_functional_equals_jax(case):
    preds, target = images(13, IMAGES)
    _close(*_both("universal_image_quality_index", preds, target, **UQI_CASES[case]),
           atol=SCALAR_ATOL * (14 * 14 * 4 if UQI_CASES[case].get("reduction") == "sum" else 1))


def test_uqi_window_past_half_the_image_is_nan_like_jax():
    """A pad as long as the image: the crop keeps no pixel, NaN in both
    packages (the port pads by replication there, which ``F.pad`` allows)."""
    preds, target = images(31, (2, 1, 6, 6))
    ref, got = _both("universal_image_quality_index", preds, target)
    assert np.isnan(float(ref)) and np.isnan(float(got))


def test_uqi_map_equals_jax_and_float64_numpy():
    preds, target = images(14, IMAGES)
    ref, got = _both("universal_image_quality_index", preds, target, reduction="none")
    _close(ref, got, atol=MAP_ATOL)
    np64 = _np_windowed(preds, target, _np_gaussian((11, 11), (1.5, 1.5)))
    np.testing.assert_allclose(_np(got).reshape(2, -1).mean(1), np64, atol=SCALAR_ATOL)


def test_uqi_flat_window_is_nan_where_jax_is_and_recorded_value():
    """A flat 16 x 16 patch in both images: the windows inside it have both
    variances 0, NaN in both packages at the same places. The windows that
    hold one to five textured rows or columns beside it keep as little as a
    tenth of the texture's variance, which ``E[x²] - μ²`` loses most of in
    float32: there the two packages agree to 2e-3 (1.1e-3 seen), elsewhere to
    the map's 1e-4."""
    preds, target = images(15, (1, 1, 32, 32))
    preds[..., :16, :16] = 0.25
    target[..., :16, :16] = 0.5
    ref, got = _both("universal_image_quality_index", preds, target, reduction="none")
    ref, got = np.asarray(ref), _np(got)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(ref).sum() == 36  # the 6 x 6 windows of the cropped map inside the patch
    beside = np.zeros(ref.shape, bool)
    beside[..., :11, :11] = True  # cropped-map windows (centres up to 15) that reach into the patch
    np.testing.assert_allclose(got[~beside], ref[~beside], atol=MAP_ATOL)
    np.testing.assert_allclose(got[beside], ref[beside], atol=2e-3, equal_nan=True)
    seeded = torch.rand([16, 1, 16, 16], generator=torch.manual_seed(42))
    np.testing.assert_allclose(float(tF.universal_image_quality_index(seeded, seeded * 0.75)), 0.9216, atol=1e-4)


UQI_ERRORS = {
    "dtype": ((2, 1, 16, 16), np.float16, {}, TypeError),
    "ndim": ((2, 1, 16, 16, 4), np.float32, {}, ValueError),
    "kernel length": ((2, 1, 16, 16), np.float32, {"kernel_size": (11,)}, ValueError),
    "even kernel": ((2, 1, 16, 16), np.float32, {"kernel_size": (4, 5)}, ValueError),
    "negative sigma": ((2, 1, 16, 16), np.float32, {"sigma": (1.5, -1.0)}, ValueError),
}


@pytest.mark.parametrize("case", sorted(UQI_ERRORS))
def test_uqi_errors_equal_jax(case):
    shape, t_dtype, kwargs, kind = UQI_ERRORS[case]
    rng = np.random.RandomState(16)
    preds, target = rng.rand(*shape).astype(np.float32), rng.rand(*shape).astype(t_dtype)
    _same_error(lambda: jF.universal_image_quality_index(jnp.asarray(preds), jnp.asarray(target), **kwargs),
                lambda: tF.universal_image_quality_index(_t(preds), _t(target), **kwargs), kind)


# ------------------------------------------------------------ ERGAS, SAM
@pytest.mark.parametrize("ratio", [4, 2, 0.25])
@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_ergas_functional_equals_jax(ratio, reduction):
    preds, target = images(17, (2, 4, 24, 24))
    _close(*_both("error_relative_global_dimensionless_synthesis", preds, target, ratio=ratio, reduction=reduction),
           rtol=RTOL)


def test_ergas_and_sam_against_float64_numpy_and_recorded_values():
    preds, target = images(18, (2, 8, 32, 32))
    p64, t64 = preds.astype(np.float64).reshape(2, 8, -1), target.astype(np.float64).reshape(2, 8, -1)
    rmse = np.sqrt(((p64 - t64) ** 2).mean(-1))
    ergas = (100 * 4 * np.sqrt(((rmse / t64.mean(-1)) ** 2).sum(1) / 8)).mean()
    np.testing.assert_allclose(float(tF.error_relative_global_dimensionless_synthesis(_t(preds), _t(target))), ergas,
                               rtol=RTOL)
    cos = (p64 * t64).sum(1) / (np.linalg.norm(p64, axis=1) * np.linalg.norm(t64, axis=1))
    np.testing.assert_allclose(float(tF.spectral_angle_mapper(_t(preds), _t(target))),
                               np.arccos(np.clip(cos, -1, 1)).mean(), atol=SAM_ATOL)
    a = torch.rand([16, 3, 16, 16], generator=torch.manual_seed(42))
    b = torch.rand([16, 3, 16, 16], generator=torch.manual_seed(123))
    np.testing.assert_allclose(float(tF.spectral_angle_mapper(a, b)), 0.5943, atol=1e-4)
    a1 = torch.rand([16, 1, 16, 16], generator=torch.manual_seed(42))
    assert round(float(tF.error_relative_global_dimensionless_synthesis(a1, a1 * 0.75))) == 154


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_sam_functional_equals_jax(reduction):
    preds, target = images(19, (2, 4, 24, 24))
    _close(*_both("spectral_angle_mapper", preds, target, reduction=reduction), atol=SAM_ATOL * (
        24 * 24 * 2 if reduction == "sum" else 1))


def test_sam_zero_vector_is_nan_where_jax_is_and_identical_is_zero():
    preds, target = images(20, (2, 3, 16, 16))
    target[0, :, 3, 4] = 0.0  # a black pixel: 0 / 0
    ref, got = _both("spectral_angle_mapper", preds, target, reduction="none")
    assert np.isnan(np.asarray(ref)[0, 3, 4])
    _close(ref, got, atol=SAM_ATOL)
    np.testing.assert_allclose(float(tF.spectral_angle_mapper(_t(preds), _t(preds))), 0.0, atol=2e-3)


@pytest.mark.parametrize("fn,shape,t_dtype,kind", [
    ("error_relative_global_dimensionless_synthesis", (2, 3, 8, 8), np.float16, TypeError),
    ("error_relative_global_dimensionless_synthesis", (2, 3, 8), np.float32, ValueError),
    ("spectral_angle_mapper", (2, 3, 8, 8), np.float16, TypeError),
    ("spectral_angle_mapper", (2, 3, 8), np.float32, ValueError),
    ("spectral_angle_mapper", (2, 1, 8, 8), np.float32, ValueError),
    ("spectral_distortion_index", (2, 3, 8, 8), np.float16, TypeError),
    ("spectral_distortion_index", (2, 3, 8), np.float32, ValueError),
])
def test_band_metric_errors_equal_jax(fn, shape, t_dtype, kind):
    rng = np.random.RandomState(21)
    preds, target = rng.rand(*shape).astype(np.float32), rng.rand(*shape).astype(t_dtype)
    _same_error(lambda: getattr(jF, fn)(jnp.asarray(preds), jnp.asarray(target)),
                lambda: getattr(tF, fn)(_t(preds), _t(target)), kind)
    wrong = rng.rand(2, 3, 8, 9).astype(np.float32)
    _same_error(lambda: getattr(jF, fn)(jnp.asarray(wrong), jnp.asarray(wrong[..., :8])),
                lambda: getattr(tF, fn)(_t(wrong), _t(wrong[..., :8])), RuntimeError)


# --------------------------------------------------------------- D-lambda
@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_d_lambda_functional_equals_jax(p, reduction):
    preds, target = images(22, (2, 6, 32, 32))
    _close(*_both("spectral_distortion_index", preds, target, p=p, reduction=reduction), **D_LAMBDA)


def test_d_lambda_one_band_identical_and_recorded_value():
    preds, target = images(23, (2, 1, 32, 32))
    _close(*_both("spectral_distortion_index", preds, target), **D_LAMBDA)
    preds, _ = images(24, (2, 4, 32, 32))
    np.testing.assert_allclose(float(tF.spectral_distortion_index(_t(preds), _t(preds))), 0.0, atol=1e-5)
    torch.manual_seed(42)
    a, b = torch.rand([16, 3, 16, 16]), torch.rand([16, 3, 16, 16])
    np.testing.assert_allclose(float(tF.spectral_distortion_index(a, b)), 0.0234, atol=1e-4)


def test_d_lambda_in_chunks_equals_one_call(monkeypatch):
    """A pair's value does not depend on its call's other pairs: 36 pairs in
    chunks of 5 give the one call's values."""
    import metrics_tpu_torch.functional.image.d_lambda as d_lambda

    preds, target = images(25, (2, 8, 24, 24))
    whole = d_lambda._pairwise_band_uqi(_t(target))
    assert d_lambda.pair_chunk(_t(target)) >= 36
    monkeypatch.setattr(d_lambda, "PAIR_CHUNK_BYTES", 5 * 2 * 34 * 34 * 4)
    assert d_lambda.pair_chunk(_t(target)) == 5
    np.testing.assert_allclose(_np(d_lambda._pairwise_band_uqi(_t(target))), _np(whole), atol=SCALAR_ATOL)
    _close(*_both("spectral_distortion_index", preds, target), **D_LAMBDA)


def test_d_lambda_errors_equal_jax():
    preds, target = images(26, (2, 3, 16, 16))
    for p in (0, 1.5, -1):
        _same_error(lambda: jF.spectral_distortion_index(jnp.asarray(preds), jnp.asarray(target), p=p),
                    lambda: tF.spectral_distortion_index(_t(preds), _t(target), p=p), ValueError)
        _same_error(lambda: J.SpectralDistortionIndex(p=p), lambda: M.SpectralDistortionIndex(p=p, device="cpu"),
                    ValueError)
    _same_error(lambda: J.SpectralDistortionIndex(reduction="max"),
                lambda: M.SpectralDistortionIndex(reduction="max", device="cpu"), ValueError)


# -------------------------------------------------------------- gradients
def test_image_gradients_are_jax_bits():
    preds, _ = images(27, (2, 3, 17, 23))
    for img in (preds, np.arange(0, 25, dtype=np.float32).reshape(1, 1, 5, 5)):
        ref, got = jF.image_gradients(jnp.asarray(img)), tF.image_gradients(_t(img))
        _close(ref, got)
    dy, dx = tF.image_gradients(_t(np.arange(0, 25, dtype=np.float32).reshape(1, 1, 5, 5)))
    assert (dy[0, 0, :4] == 5).all() and (dy[0, 0, 4] == 0).all() and (dx[0, 0, :, :4] == 1).all()


def test_image_gradients_errors_equal_jax():
    img = np.zeros((1, 5, 5), np.float32)
    _same_error(lambda: jF.image_gradients(jnp.asarray(img)), lambda: tF.image_gradients(_t(img)), RuntimeError)
    with pytest.raises(TypeError, match=r"expects a value of <Array> type but got <class 'numpy.ndarray'>"):
        tF.image_gradients(img[None])
    with pytest.raises(TypeError, match=r"expects a value of <Array> type but got <class 'numpy.ndarray'>"):
        jF.image_gradients(img[None])


# ---------------------------------------------------------------- modules
MODULES = {
    "psnr": ("PeakSignalNoiseRatio", {}, IMAGES),
    "psnr dim": ("PeakSignalNoiseRatio", {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"}, IMAGES),
    "ssim": ("StructuralSimilarityIndexMeasure", {}, IMAGES),
    "ssim cs": ("StructuralSimilarityIndexMeasure", {"return_contrast_sensitivity": True, "reduction": "none"},
                IMAGES),
    "ms-ssim": ("MultiScaleStructuralSimilarityIndexMeasure", {"kernel_size": 5, "sigma": 0.5, "betas": MS_BETAS},
                (1, 1, 32, 32)),
    "uqi": ("UniversalImageQualityIndex", {}, IMAGES),
    "ergas": ("ErrorRelativeGlobalDimensionlessSynthesis", {"ratio": 2}, (2, 4, 24, 24)),
    "sam": ("SpectralAngleMapper", {}, (2, 4, 24, 24)),
    "d-lambda": ("SpectralDistortionIndex", {"p": 2, "reduction": "sum"}, (2, 4, 24, 24)),
}


def _assert_states(jm, tm):
    """Every state: the images of the list states exact, sums (and PSNR's
    per-image sums) to rtol 1e-5, PSNR's int64 count equal to the JAX
    package's int32 count."""
    assert list(jm._defaults) == list(tm._defaults)
    for key in jm._defaults:
        j, t = getattr(jm, key), getattr(tm, key)
        pairs = list(zip(j, t)) if isinstance(j, list) else [(j, t)]
        assert not isinstance(j, list) or len(j) == len(t), key
        for a, b in pairs:
            if key == "total":
                assert b.dtype == torch.int64 and str(a.dtype) == "int32"
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            elif key in ("preds", "target"):
                _close(a, b)
            else:
                _close(a, b, rtol=RTOL)


@pytest.mark.parametrize("case", sorted(MODULES))
def test_module_update_forward_compute_reset_equal_jax(case):
    """``forward`` on a batch (its value), ``update`` on a second, the
    states, ``compute`` over both, ``reset``, then one batch again."""
    cls, kwargs, shape = MODULES[case]
    preds, target = images(28, (2 * shape[0],) + shape[1:])
    (p0, t0), (p1, t1) = (preds[:shape[0]], target[:shape[0]]), (preds[shape[0]:], target[shape[0]:])
    jm, tm = getattr(J, cls)(**kwargs), getattr(M, cls)(**kwargs, device="cpu")
    tol = _tol(cls)
    _close(jm(jnp.asarray(p0), jnp.asarray(t0)), tm(_t(p0), _t(t0)), **tol)
    jm.update(jnp.asarray(p1), jnp.asarray(t1))
    tm.update(_t(p1), _t(t1))
    _assert_states(jm, tm)
    _close(jm.compute(), tm.compute(), **tol)
    jm.reset()
    tm.reset()
    for key, default in tm._defaults.items():
        value = getattr(tm, key)
        assert value == [] if isinstance(default, list) else torch.equal(value, default), key
    jm.update(jnp.asarray(p1), jnp.asarray(t1))
    tm.update(_t(p1), _t(t1))
    _close(jm.compute(), tm.compute(), **tol)
    assert tm.full_state_update is False and tm.higher_is_better == jm.higher_is_better
    assert tm.is_differentiable == jm.is_differentiable


def test_module_update_errors_equal_jax():
    a, b = np.zeros((2, 3, 16, 16), np.float32), np.zeros((2, 3, 16, 16), np.float16)
    for cls in ("StructuralSimilarityIndexMeasure", "MultiScaleStructuralSimilarityIndexMeasure",
                "UniversalImageQualityIndex", "ErrorRelativeGlobalDimensionlessSynthesis", "SpectralAngleMapper",
                "SpectralDistortionIndex"):
        jm, tm = getattr(J, cls)(), getattr(M, cls)(device="cpu")
        _same_error(lambda: jm.update(jnp.asarray(a), jnp.asarray(b)), lambda: tm.update(_t(a), _t(b)), TypeError)
        _same_error(lambda: jm.update(jnp.asarray(a), jnp.asarray(a[:1])), lambda: tm.update(_t(a), _t(a[:1])),
                    RuntimeError)


# ------------------------------------------------------------------ bf16
@pytest.mark.parametrize("fn,kwargs,bound", [
    ("peak_signal_noise_ratio", {"data_range": 1.0}, 0.5),
    ("peak_signal_noise_ratio", {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"}, 0.5),
    ("structural_similarity_index_measure", {}, 5e-2),
])
def test_bfloat16_inputs_equal_jax(fn, kwargs, bound):
    preds, target = images(29, IMAGES)
    ref = getattr(jF, fn)(jnp.asarray(preds, jnp.bfloat16), jnp.asarray(target, jnp.bfloat16), **kwargs)
    got = getattr(tF, fn)(_t(preds).bfloat16(), _t(target).bfloat16(), **kwargs)
    full = getattr(tF, fn)(_t(preds), _t(target), **kwargs)
    assert _dtype(got) == str(ref.dtype)
    np.testing.assert_allclose(_np(got), _np(ref), atol=bound)
    np.testing.assert_allclose(_np(got), _np(full), atol=bound)


@pytest.mark.parametrize("kwargs", [{}, {"data_range": 1.0}, {"data_range": 1.0, "dim": (1, 2, 3)}])
def test_bfloat16_psnr_module_states_and_value_equal_jax(kwargs):
    preds, target = images(30, IMAGES)
    jm, tm = J.PeakSignalNoiseRatio(**kwargs), M.PeakSignalNoiseRatio(**kwargs, device="cpu")
    for i in (0, 1):
        jm.update(jnp.asarray(preds[i:i + 1], jnp.bfloat16), jnp.asarray(target[i:i + 1], jnp.bfloat16))
        tm.update(_t(preds[i:i + 1]).bfloat16(), _t(target[i:i + 1]).bfloat16())
    for key in jm._defaults:
        j, t = getattr(jm, key), getattr(tm, key)
        for a, b in (zip(j, t) if isinstance(j, list) else [(j, t)]):
            assert _dtype(b) == ("int64" if key == "total" else str(a.dtype)), key
    ref, got = jm.compute(), tm.compute()
    assert _dtype(got) == str(ref.dtype)
    np.testing.assert_allclose(_np(got), _np(ref), atol=0.5)
