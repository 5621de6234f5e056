"""The port's image metrics through the paths around them, held against the
JAX package on the CPU: a ``MetricCollection`` (compute groups, the fused
collection's eager fall-back), the engines (``PeakSignalNoiseRatio`` with
``jit_update=True``, the list-state metrics that stay eager), sync across two
rank threads, JAX <-> port checkpoints, and the two reference faults the port
does not copy (ROADMAP.md Queue C):

* PSNR's count: the JAX package keeps ``total`` in int32 (x64 off), so past
  2**31 - 1 values it wraps and the value is NaN (Cityscapes val at full
  resolution is 3,145,728,000 values). The port keeps it in int64; the
  checkpoint boundary widens an int32 count and refuses to export one past
  int32.
* UQI's crop: the JAX package slices ``p:-p``, empty for a 1-wide window
  (``kernel_size=(1, 11)``), and gives NaN; the port crops
  ``slice(p, size - p)`` and gives the float64 value.

Tolerances as in ``tests/test_torch_image.py``: the windowed values atol
1e-5, PSNR rtol 1e-5, integer states and list-state images exact, the port's
engine bit-equal to its eager path.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu.functional as jF
import metrics_tpu_torch as M
from metrics_tpu.collections import MetricCollection as JaxCollection
from metrics_tpu.parallel.dist_env import NoOpEnv as JaxNoOp
from metrics_tpu_torch.interop import load_jax_state_dict, to_jax_state_dict
from metrics_tpu_torch.parallel import NoOpEnv
from tests.test_torch_image import MS_BETAS, images

SCALAR_ATOL, RTOL = 1e-5, 1e-5
TIMEOUT_S = 30
# the compute groups the JAX package forms for the codec-evaluation collection (chip_smoke.py's
# KODAK_GROUPS holds the same on the card)
KODAK_GROUPS = {0: ["ms_ssim", "ssim", "uqi"], 1: ["psnr"]}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _kodak_members(pkg, **kwargs):
    """PSNR, SSIM, MS-SSIM (three scales, a 5-tap window) and UQI, keyed in
    the JAX package's group order."""
    return {
        "psnr": pkg.PeakSignalNoiseRatio(data_range=1.0, **kwargs),
        "ssim": pkg.StructuralSimilarityIndexMeasure(data_range=1.0, **kwargs),
        "ms_ssim": pkg.MultiScaleStructuralSimilarityIndexMeasure(kernel_size=5, sigma=0.5, betas=MS_BETAS,
                                                                  data_range=1.0, **kwargs),
        "uqi": pkg.UniversalImageQualityIndex(**kwargs),
    }


def _same_values(ref, got):
    assert list(ref) == list(got)
    for key in ref:
        tol = {"rtol": RTOL} if key.endswith("psnr") else {"atol": SCALAR_ATOL}
        np.testing.assert_allclose(_np(got[key]), _np(ref[key]), **tol, err_msg=key)


# ------------------------------------------------------------ collections
@pytest.mark.parametrize("fused", [None, True])
def test_codec_collection_groups_and_values_equal_jax(fused):
    """The JAX package's two groups, its values over three batches and its
    forward values; a fused collection falls back to the eager loop for good
    (its members hold list states) in both packages, with the same values."""
    jm = JaxCollection(_kodak_members(J), prefix="kodak_")
    tm = M.MetricCollection(_kodak_members(M, device="cpu"), prefix="kodak_", fused_update=fused)
    batches = [images(40 + i, (2, 3, 32, 32)) for i in range(3)]
    for i, (p, t) in enumerate(batches):
        if i == 1:
            _same_values(jm(jnp.asarray(p), jnp.asarray(t)), tm(_t(p), _t(t)))
        else:
            jm.update(jnp.asarray(p), jnp.asarray(t))
            tm.update(_t(p), _t(t))
    assert tm.compute_groups == jm.compute_groups == KODAK_GROUPS
    _same_values(jm.compute(), tm.compute())
    assert tm.dispatch_stats["dispatches"] == 0
    for name in ("ssim", "ms_ssim", "uqi"):
        for a, b in zip(getattr(jm["ms_ssim"], "preds"), getattr(tm[name], "preds")):
            np.testing.assert_array_equal(_np(b), _np(a))
    assert tm["psnr"].total.dtype == torch.int64 and int(tm["psnr"].total) == 3 * 2 * 3 * 32 * 32


# ---------------------------------------------------------------- engines
@pytest.mark.parametrize("kwargs", [{}, {"data_range": 1.0}], ids=["range from the targets", "range given"])
def test_psnr_engine_is_bit_equal_to_eager_and_counts_like_jax(kwargs):
    """``jit_update=True`` over batches of two shapes: the port's states
    bit-equal to its eager update's, JAX's engine's states and value to the
    tolerance, the same dispatches and retraces; the fused forward's batch
    values bit-equal to the eager forward's."""
    shapes = [(2, 3, 24, 24), (2, 3, 24, 24), (1, 3, 24, 24), (2, 3, 24, 24)]
    batches = [images(50 + i, s) for i, s in enumerate(shapes)]
    eager = M.PeakSignalNoiseRatio(**kwargs, device="cpu")
    tm = M.PeakSignalNoiseRatio(**kwargs, jit_update=True, device="cpu")
    jm = J.PeakSignalNoiseRatio(**kwargs, jit_update=True)
    for p, t in batches:
        eager.update(_t(p), _t(t))
        tm.update(_t(p), _t(t))
        jm.update(jnp.asarray(p), jnp.asarray(t))
    for key in eager._defaults:
        a, b = getattr(eager, key), getattr(tm, key)
        assert a.dtype == b.dtype and torch.equal(a, b), key
        np.testing.assert_allclose(_np(b), _np(getattr(jm, key)), rtol=RTOL)
    assert tm.total.dtype == torch.int64
    assert torch.equal(tm.compute(), eager.compute())
    np.testing.assert_allclose(_np(tm.compute()), _np(jm.compute()), rtol=RTOL)
    for stat in ("dispatches", "retraces", "demotions"):
        assert tm.dispatch_stats[stat] == jm.dispatch_stats[stat], (stat, tm.dispatch_stats, jm.dispatch_stats)
    fwd_eager = M.PeakSignalNoiseRatio(**kwargs, device="cpu")
    fwd = M.PeakSignalNoiseRatio(**kwargs, jit_update=True, device="cpu")
    for p, t in batches:
        assert torch.equal(fwd(_t(p), _t(t)), fwd_eager(_t(p), _t(t)))
    assert fwd.forward_stats["launches"] == len(batches) and fwd.forward_stats["demotions"] == 0
    for key in fwd_eager._defaults:
        assert torch.equal(getattr(fwd, key), getattr(fwd_eager, key)), key


@pytest.mark.parametrize("cls,kwargs", [
    ("StructuralSimilarityIndexMeasure", {}),
    ("UniversalImageQualityIndex", {}),
    ("SpectralAngleMapper", {}),
    ("PeakSignalNoiseRatio", {"data_range": 1.0, "dim": (1, 2, 3)}),
])
def test_list_state_metrics_with_jit_update_stay_eager_like_jax(cls, kwargs):
    jm = getattr(J, cls)(**kwargs, jit_update=True)
    tm = getattr(M, cls)(**kwargs, jit_update=True, device="cpu")
    ref = getattr(M, cls)(**kwargs, device="cpu")
    for i in range(2):
        p, t = images(60 + i, (2, 3, 24, 24))
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(_t(p), _t(t))
        ref.update(_t(p), _t(t))
    assert tm._dispatcher is None and tm.dispatch_stats["dispatches"] == 2 and tm.dispatch_stats["retraces"] == 0
    assert jm.dispatch_stats["retraces"] == 0
    assert torch.equal(tm.compute(), ref.compute())
    np.testing.assert_allclose(_np(tm.compute()), _np(jm.compute()), atol=1e-3 if cls == "SpectralAngleMapper"
                               else SCALAR_ATOL, rtol=RTOL)


# ------------------------------------------------------------------- sync
class _Exchange:
    def __init__(self):
        self.barrier = threading.Barrier(2, timeout=TIMEOUT_S)
        self.slots = [None, None]

    def gather(self, rank, x):
        self.slots[rank] = x
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


class JaxPair(JaxNoOp):
    def __init__(self, exchange, rank):
        self.exchange, self.rank = exchange, rank

    def world_size(self):
        return 2

    def all_gather(self, x):
        return self.exchange.gather(self.rank, jnp.atleast_1d(x))


class TorchPair(NoOpEnv):
    def __init__(self, exchange, rank):
        self.exchange, self.rank = exchange, rank

    def world_size(self):
        return 2

    def all_gather(self, x):
        return self.exchange.gather(self.rank, torch.atleast_1d(x))


def run_ranks(fn, env_cls):
    """``fn(rank, env)`` on two threads, one a rank; their results, or the
    first error re-raised (the ``tests/test_torch_sync.py`` harness)."""
    exchange = _Exchange()
    results, errors = [None, None], [None, None]

    def body(rank):
        try:
            results[rank] = fn(rank, env_cls(exchange, rank))
        except BaseException as err:  # noqa: BLE001 -- re-raised on the test's thread
            errors[rank] = err
            exchange.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT_S)
        assert not t.is_alive(), "a rank thread hung"
    for err in sorted((e for e in errors if e is not None), key=lambda e: isinstance(e, threading.BrokenBarrierError)):
        raise err
    return results


@pytest.mark.parametrize("cls,kwargs", [
    ("PeakSignalNoiseRatio", {}),
    ("PeakSignalNoiseRatio", {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"}),
    ("StructuralSimilarityIndexMeasure", {"data_range": 1.0}),
])
def test_sync_on_two_ranks_equals_jax(cls, kwargs):
    """Each rank its own batches; ``compute`` syncs through the env: the
    synced states and values equal the JAX package's and the single-process
    run over both ranks' batches; the same collectives and buckets (PSNR's
    int64 counts cross as 8 bytes each where JAX's int32 cross as 4)."""
    data = [[images(70 + 3 * r + i, (2, 3, 24, 24)) for i in range(2 + r)] for r in range(2)]

    def make(pkg):
        conv = jnp.asarray if pkg is J else _t

        def fn(rank, env):
            m = getattr(pkg, cls)(**kwargs) if pkg is J else getattr(pkg, cls)(**kwargs, device="cpu")
            m._sync_env = env
            for p, t in data[rank]:
                m.update(conv(p), conv(t))
            counts = getattr(m, "total", [])
            counts = sum(int(np.prod(tuple(x.shape))) for x in (counts if isinstance(counts, list) else [counts]))
            value = m.compute()
            m.sync(env=env)
            states = {k: getattr(m, k) for k in m._defaults}
            return _np(value), states, dict(m.sync_stats), counts

        return fn

    touts, jouts = run_ranks(make(M), TorchPair), run_ranks(make(J), JaxPair)
    single = getattr(M, cls)(**kwargs, device="cpu")
    for p, t in data[0] + data[1]:
        single.update(_t(p), _t(t))
    tol = {"rtol": RTOL} if cls == "PeakSignalNoiseRatio" else {"atol": SCALAR_ATOL}
    for (tv, ts, tstats, counts), (jv, js, jstats, _) in zip(touts, jouts):
        np.testing.assert_allclose(tv, jv, **tol)
        np.testing.assert_allclose(tv, _np(single.compute()), **tol)
        for key in js:
            t_leaf = torch.cat([torch.atleast_1d(x) for x in ts[key]]) if isinstance(ts[key], list) else ts[key]
            j_leaf = jnp.concatenate([jnp.atleast_1d(x) for x in js[key]]) if isinstance(js[key], list) else js[key]
            if key == "total":
                assert t_leaf.dtype == torch.int64
                np.testing.assert_array_equal(_np(t_leaf), _np(j_leaf))
            elif key in ("preds", "target"):
                np.testing.assert_array_equal(_np(t_leaf), _np(j_leaf))
            else:
                np.testing.assert_allclose(_np(t_leaf), _np(j_leaf), rtol=RTOL)
        assert tstats["collectives"] == jstats["collectives"] and tstats["buckets"] == jstats["buckets"]
        # each local count element crosses 4 bytes wider, once in compute and once in sync()
        assert tstats["bytes_on_wire"] - jstats["bytes_on_wire"] == 2 * 4 * counts


def test_synced_count_sums_in_int64_past_int32():
    """Two ranks of 2**31 - 100 counted values each: the synced count is
    their int64 sum and the value the float64 closed form."""
    start = 2**31 - 100

    def fn(rank, env):
        p, t = images(80 + rank, (2, 3, 16, 16))
        m = M.PeakSignalNoiseRatio(data_range=1.0, device="cpu", sync_env=env)
        m.update(_t(p), _t(t))
        object.__setattr__(m, "total", m.total + (start - p.size))
        value = float(m.compute())  # synced inside compute, then the local states back
        m.sync(env=env)
        return int(m.total), float(m.sum_squared_error), value

    (total0, sse0, v0), (total1, _, v1) = run_ranks(fn, TorchPair)
    assert total0 == total1 == 2 * start
    assert v0 == v1
    np.testing.assert_allclose(v0, 10 * np.log10(1.0 / (np.float64(sse0) / (2 * start))), rtol=RTOL)


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("cls,kwargs", [
    ("PeakSignalNoiseRatio", {}),
    ("PeakSignalNoiseRatio", {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"}),
    ("StructuralSimilarityIndexMeasure", {}),
    ("SpectralDistortionIndex", {}),
])
def test_checkpoints_cross_between_jax_and_port(cls, kwargs):
    """JAX -> port (an int32 count comes in as int64) -> JAX, then more
    batches in all three: the same states and values."""
    batches = [images(90 + i, (2, 3, 24, 24)) for i in range(4)]
    jm, tm = getattr(J, cls)(**kwargs), getattr(M, cls)(**kwargs, device="cpu")
    jm.persistent(True)
    tm.persistent(True)
    for p, t in batches[:2]:
        jm.update(jnp.asarray(p), jnp.asarray(t))
    load_jax_state_dict(tm, jm.state_dict())
    if "total" in tm._defaults:
        totals = tm.total if isinstance(tm.total, list) else [tm.total]
        assert all(x.dtype == torch.int64 for x in totals)
    back = getattr(J, cls)(**kwargs)
    back.load_state_dict(to_jax_state_dict(tm))
    for p, t in batches[2:]:
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(_t(p), _t(t))
        back.update(jnp.asarray(p), jnp.asarray(t))
    tol = {"rtol": RTOL} if cls in ("PeakSignalNoiseRatio", "SpectralDistortionIndex") else {"atol": SCALAR_ATOL}
    if cls == "SpectralDistortionIndex":
        tol["atol"] = 1e-6  # a mean of differences of UQI values (tests/test_torch_image.py's D_LAMBDA)
    for ref in (jm, back):
        np.testing.assert_allclose(_np(tm.compute()), _np(ref.compute()), **tol)


def test_collection_checkpoint_crosses_and_an_overflowing_count_refuses_to_export():
    jm = JaxCollection(_kodak_members(J))
    tm = M.MetricCollection(_kodak_members(M, device="cpu"))
    jm.persistent(True)
    tm.persistent(True)
    p, t = images(95, (2, 3, 32, 32))
    jm.update(jnp.asarray(p), jnp.asarray(t))
    load_jax_state_dict(tm, jm.state_dict())
    assert tm["psnr"].total.dtype == torch.int64 and int(tm["psnr"].total) == p.size
    _same_values(jm.compute(), tm.compute())
    back = JaxCollection(_kodak_members(J))
    back.load_state_dict(to_jax_state_dict(tm))
    _same_values(back.compute(), tm.compute())
    object.__setattr__(tm["psnr"], "total", torch.tensor(2**31, dtype=torch.int64))
    with pytest.raises(OverflowError, match="'psnr.total' holds a count past int32"):
        to_jax_state_dict(tm)


# ------------------------------------------------------- reference faults
def test_psnr_count_past_int32_is_finite_where_jax_wraps_to_nan():
    """``total`` at 2**31 - 100, then one 16 x 16 update: JAX's int32 count
    wraps to -2,147,483,492 and its value is NaN; the port's count is
    2**31 + 156 and its value the float64 closed form. Exporting that count
    to the JAX package raises instead of wrapping."""
    img = np.random.RandomState(96).rand(1, 1, 16, 16).astype(np.float32)
    target = np.clip(img + 0.01, 0, 1)
    jm, tm = J.PeakSignalNoiseRatio(data_range=1.0), M.PeakSignalNoiseRatio(data_range=1.0, device="cpu")
    object.__setattr__(jm, "total", jnp.asarray(2**31 - 100, jnp.int32))
    object.__setattr__(tm, "total", torch.tensor(2**31 - 100, dtype=torch.int64))
    jm.update(jnp.asarray(img), jnp.asarray(target))
    tm.update(_t(img), _t(target))
    assert int(jm.total) == -2_147_483_492 and np.isnan(float(jm.compute()))
    assert tm.total.dtype == torch.int64 and int(tm.total) == 2**31 + 156
    want = 10 * np.log10(1.0 / (np.float64(float(tm.sum_squared_error)) / (2**31 + 156)))
    np.testing.assert_allclose(float(tm.compute()), want, rtol=RTOL)
    tm.persistent(True)
    with pytest.raises(OverflowError, match="count past int32"):
        to_jax_state_dict(tm)


def _np_uqi(preds, target, kernel_size, sigma):
    """Float64 UQI with the crop ``slice(p, size - p)``: reflect-pad, valid
    correlation with the gaussian window, mean over the cropped maps."""
    kernel = None
    for ks, sg in zip(kernel_size, sigma):
        x = np.arange(ks, dtype=np.float64) - (ks - 1) / 2
        g = np.exp(-(x**2) / (2 * sg**2))
        kernel = g / g.sum() if kernel is None else np.multiply.outer(kernel, g / g.sum())
    pads = [(k - 1) // 2 for k in kernel_size]

    def correlate(x):
        return np.tensordot(np.lib.stride_tricks.sliding_window_view(x, kernel.shape), kernel, axes=2)

    maps = []
    for b in range(preds.shape[0]):
        for c in range(preds.shape[1]):
            p = np.pad(preds[b, c].astype(np.float64), [(d, d) for d in pads], mode="reflect")
            t = np.pad(target[b, c].astype(np.float64), [(d, d) for d in pads], mode="reflect")
            mu_p, mu_t = correlate(p), correlate(t)
            s_pp, s_tt = correlate(p * p) - mu_p**2, correlate(t * t) - mu_t**2
            s_pt = correlate(p * t) - mu_p * mu_t
            m = (4 * mu_p * mu_t * s_pt) / ((mu_p**2 + mu_t**2) * (s_pp + s_tt))
            maps.append(m[tuple(slice(d, n - d) for d, n in zip(pads, m.shape))])
    return np.mean(maps)


@pytest.mark.parametrize("kernel_size", [(1, 11), (11, 1), (3, 11)])
def test_uqi_with_a_one_wide_window_is_the_float64_value_where_jax_is_nan(kernel_size):
    """``kernel_size=(1, 11)``: the JAX package's ``p:-p`` crop is empty on the
    1-wide axis and its value NaN; the port's equals float64 numpy. At
    ``(3, 11)`` both packages crop alike and agree."""
    preds, target = images(97, (2, 2, 32, 32))
    got = M.functional.universal_image_quality_index(_t(preds), _t(target), kernel_size=kernel_size)
    ref = jF.universal_image_quality_index(jnp.asarray(preds), jnp.asarray(target), kernel_size=kernel_size)
    np.testing.assert_allclose(float(got), _np_uqi(preds, target, kernel_size, (1.5, 1.5)), atol=SCALAR_ATOL)
    if 1 in kernel_size:
        assert np.isnan(float(ref))
    else:
        np.testing.assert_allclose(float(got), float(ref), atol=SCALAR_ATOL)
    module = M.UniversalImageQualityIndex(kernel_size=kernel_size, device="cpu")
    module.update(_t(preds), _t(target))
    assert torch.equal(module.compute(), got)
