"""The port's streaming slice held against the JAX package on the CPU.

The same seeded numpy inputs go through ``metrics_tpu`` and
``metrics_tpu_torch``. The hash, the key bits, the leading-zero count and
the count-min table must be equal bit for bit (the table for integral
weights, which is the JAX parity suite's contract; other weights to
``rtol=1e-6``), against both JAX formulations of the count-min update: the
lax scatter and the Pallas kernel body in interpret mode, called directly.
Sketch and aggregator states must be equal exactly and values agree to
``rtol=1e-6`` (float32 sums in another order). The CUDA kernel itself runs
only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import metrics_tpu
import metrics_tpu_torch
from metrics_tpu.ops.sketch_ops import _countmin_lax, _countmin_pallas
from metrics_tpu.ops.sketch_ops import hash_u32 as jax_hash_u32
from metrics_tpu.streaming import sketch as jax_sketch
from metrics_tpu_torch.interop import load_jax_state_dict, to_jax_state_dict
from metrics_tpu_torch.ops import countmin_update, hash_u32, launches, reset_launches
from metrics_tpu_torch.ops.sketch_ops import as_u32_bits
from metrics_tpu_torch.streaming import sketch as port_sketch

RTOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))  # a copy, C-ordered, 0-d kept


def _assert_same(ref, got, exact):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)


def _words(n, seed):
    rng = np.random.RandomState(seed)
    words = rng.randint(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    words[:4] = [0, 1, 2**31, 2**32 - 1]
    return words


def _seeds(depth):
    return (np.arange(depth, dtype=np.uint32) * np.uint32(0x9E3779B9) + np.uint32(1)).astype(np.uint32)


# --------------------------------------------------------------- hash, bits
def test_hash_u32_matches_jax():
    words = _words(5000, seed=0)
    got = hash_u32(as_u32_bits(_t(words)))
    assert got.dtype == torch.int64 and int(got.min()) >= 0 and int(got.max()) < 2**32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_hash_u32(jnp.asarray(words))).astype(np.int64))


def test_as_u32_bits_takes_int32_and_uint32_alike():
    words = _words(64, seed=1)
    np.testing.assert_array_equal(as_u32_bits(_t(words)).numpy(), as_u32_bits(_t(words.view(np.int32))).numpy())
    with pytest.raises(TypeError, match="32-bit"):
        as_u32_bits(torch.zeros(3, dtype=torch.int64))


def test_key_bits_match_jax():
    rng = np.random.RandomState(2)
    x = np.concatenate([rng.randn(200), [0.0, -0.0, 1.0, 2.0, np.inf, -np.inf, 1e-30, 3e38]]).astype(np.float32)
    ref = np.asarray(jax_sketch._key_bits(jnp.asarray(x)))
    got = port_sketch._key_bits(_t(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
    assert int(got[-8]) == int(got[-7]) == 0  # -0.0 hashes as +0.0


def test_clz_matches_lax_clz():
    words = _words(5000, seed=3)
    ref = np.asarray(lax.clz(jnp.asarray(words))).astype(np.int64)
    got = port_sketch._clz32(as_u32_bits(_t(words)))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got[:4].tolist() == [32, 31, 0, 0]


# ------------------------------------------------------------ countmin_update
@pytest.mark.parametrize("n", [1, 100, 128, 255, 257, 300])
@pytest.mark.parametrize("depth,width", [(2, 128), (4, 1024), (1, 1000), (8, 1023)])
def test_countmin_plain_matches_jax_lax_and_pallas(n, depth, width):
    # the grid of tests/ops/test_kernel_parity.py: integral weights, exact
    rng = np.random.RandomState(n + depth)
    value = rng.randint(0, 50, (depth, width)).astype(np.float32)
    bits = rng.randint(0, 2**31, n).astype(np.uint32)
    w = rng.randint(0, 3, n).astype(np.float32)
    seeds = _seeds(depth)
    got = countmin_update(_t(value), _t(bits), _t(w), _t(seeds))
    jv, jb, jw, js = (jnp.asarray(a) for a in (value, bits, w, seeds))
    _assert_same(_countmin_lax(jv, jb, jw, js), got, exact=True)
    _assert_same(_countmin_pallas(jv, jb, jw, js, interpret=True), got, exact=True)


@pytest.mark.parametrize("depth,width", [(4, 1000), (4, 1024), (1, 1023)])
def test_countmin_single_hot_key_matches_jax_lax_and_pallas(depth, width):
    # every key equal: one cell a row takes the whole batch (the kernel's warp-aggregation edge)
    rng = np.random.RandomState(width)
    value = rng.randint(0, 50, (depth, width)).astype(np.float32)
    bits = np.full(257, 0xDEADBEEF, np.uint32)
    w = rng.randint(0, 3, 257).astype(np.float32)
    seeds = _seeds(depth)
    got = countmin_update(_t(value), _t(bits), _t(w), _t(seeds))
    jv, jb, jw, js = (jnp.asarray(a) for a in (value, bits, w, seeds))
    _assert_same(_countmin_lax(jv, jb, jw, js), got, exact=True)
    _assert_same(_countmin_pallas(jv, jb, jw, js, interpret=True), got, exact=True)
    assert ((got.numpy() - value) != 0).sum(axis=1).tolist() == [1] * depth


def test_countmin_fractional_weights_agree_to_float32_rounding():
    rng = np.random.RandomState(5)
    bits = (rng.zipf(1.3, 4000) % 300).astype(np.uint32)  # heavy repeats
    w = rng.rand(4000).astype(np.float32)
    value = np.zeros((3, 64), np.float32)
    got = countmin_update(_t(value), _t(bits), _t(w), _t(_seeds(3)))
    ref = _countmin_lax(*(jnp.asarray(a) for a in (value, bits, w, _seeds(3))))
    _assert_same(ref, got, exact=False)


def test_countmin_wide_table_and_int32_bits():
    # no width limit in the port (the JAX kernel's VMEM bound is its own)
    rng = np.random.RandomState(6)
    bits = rng.randint(0, 2**32, 500, dtype=np.uint64).astype(np.uint32)
    w = np.ones(500, np.float32)
    value = np.zeros((2, 65536), np.float32)
    got = countmin_update(_t(value), _t(bits.view(np.int32)), _t(w), _t(_seeds(2).view(np.int32)))
    _assert_same(_countmin_lax(*(jnp.asarray(a) for a in (value, bits, w, _seeds(2)))), got, exact=True)
    assert got.sum(dim=1).tolist() == [500.0, 500.0]


def test_countmin_rejects_bad_shapes_and_counts_no_cpu_launch():
    v, b, w, s = torch.zeros(2, 8), torch.zeros(5, dtype=torch.int32), torch.ones(5), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="expects"):
        countmin_update(v, b, torch.ones(4), s)
    with pytest.raises(ValueError, match="expects"):
        countmin_update(v, b, w, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="no kernel"):
        countmin_update(v.to("meta"), b.to("meta"), w.to("meta"), s.to("meta"))
    reset_launches()
    countmin_update(v, b, w, s)
    assert launches()["countmin"] == 0


# --------------------------------------------------------------- aggregators
def _stream(seed, nan=True):
    rng = np.random.RandomState(seed)
    out = []
    for n in (17, 1, 40):
        x = (rng.rand(n) * 4 + 0.5).astype(np.float32)  # positive: float sums without cancellation
        if nan and n > 1:
            x[::5] = np.nan
        out.append(x)
    return out


def _assert_states(jm, tm, exact=True):
    for name in jm._defaults:
        ref, got = getattr(jm, name), getattr(tm, name)
        if isinstance(ref, list):
            assert isinstance(got, list) and len(got) == len(ref)
            if not ref:
                continue
            ref, got = jnp.concatenate([jnp.atleast_1d(r) for r in ref]), torch.cat([torch.atleast_1d(g) for g in got])
        _assert_same(ref, got, exact=exact)


def _drive(jm, tm, batches, weights=None, exact_values=False, exact_states=True):
    """Updates (forward on the second batch), states and values after each.
    Float sums (``SumMetric``, ``MeanMetric``) differ in their last bits
    with the order of the adds: ``exact_states=False`` holds them to rtol."""
    for i, x in enumerate(batches):
        args_j, args_t = [jnp.asarray(x)], [_t(x)]
        if weights is not None:
            args_j.append(jnp.asarray(weights[i]))
            args_t.append(_t(weights[i]))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            if i == 1:
                _assert_same(jm(*args_j), tm(*args_t), exact=exact_values)
            else:
                jm.update(*args_j)
                tm.update(*args_t)
        _assert_states(jm, tm, exact=exact_states)
        _assert_same(jm.compute(), tm.compute(), exact=exact_values)
    tm.reset()
    jm.reset()
    _assert_states(jm, tm)


_AGGREGATORS = ["SumMetric", "MeanMetric", "MaxMetric", "MinMetric", "CatMetric"]


@pytest.mark.parametrize("metric", _AGGREGATORS)
@pytest.mark.parametrize("nan_strategy", ["warn", "ignore", 2.0, 0])
def test_aggregators_match_jax(metric, nan_strategy):
    jm = getattr(metrics_tpu, metric)(nan_strategy=nan_strategy)
    tm = getattr(metrics_tpu_torch, metric)(nan_strategy=nan_strategy, device="cpu")
    _drive(jm, tm, _stream(seed=len(metric)), exact_states=metric not in ("SumMetric", "MeanMetric"))


@pytest.mark.parametrize("metric", _AGGREGATORS)
def test_aggregators_nan_error_raises_alike(metric):
    jm = getattr(metrics_tpu, metric)(nan_strategy="error")
    tm = getattr(metrics_tpu_torch, metric)(nan_strategy="error", device="cpu")
    _drive(jm, tm, _stream(seed=1, nan=False), exact_states=metric not in ("SumMetric", "MeanMetric"))
    x = np.array([1.0, np.nan], np.float32)
    with pytest.raises(RuntimeError, match="nan") as jax_err:
        jm.update(jnp.asarray(x))
    with pytest.raises(RuntimeError, match="nan") as torch_err:
        tm.update(_t(x))
    assert str(jax_err.value) == str(torch_err.value)


def test_nan_warn_warns_alike():
    x = np.array([1.0, np.nan], np.float32)
    with pytest.warns(UserWarning, match="Will be removed"):
        metrics_tpu_torch.SumMetric(device="cpu").update(_t(x))


def test_mean_metric_weights_and_scalar_inputs_match_jax():
    jm, tm = metrics_tpu.MeanMetric(), metrics_tpu_torch.MeanMetric(device="cpu")
    batches = _stream(seed=9)
    weights = [np.abs(b) + 0.5 for b in batches]
    weights[2][3] = np.nan  # a NaN weight drops its pair
    _drive(jm, tm, batches, weights=weights, exact_states=False)
    for value in (3.0, 0.25):  # Python scalars
        jm.update(value)
        tm.update(value)
    _assert_same(jm.compute(), tm.compute(), exact=False)


@pytest.mark.parametrize("bad", ["casual", True, None])
def test_aggregator_constructor_errors_match_jax(bad):
    with pytest.raises(ValueError) as jax_err:
        metrics_tpu.SumMetric(nan_strategy=bad)
    with pytest.raises(ValueError) as torch_err:
        metrics_tpu_torch.SumMetric(nan_strategy=bad, device="cpu")
    assert str(jax_err.value) == str(torch_err.value)


# ---------------------------------------------------------------- sketches
def _off_edges(x, gamma):
    """Values whose log-ratio to the bucket base is not within 1e-3 of an
    integer: torch and XLA may round ``log`` by one ulp apart, which moves a
    value on a bucket edge into the next bucket."""
    key = np.log(np.abs(x.astype(np.float64))) / np.log(gamma)
    return x[np.abs(key - np.round(key)) > 1e-3]


def _quantile_stream(seed, gamma):
    rng = np.random.RandomState(seed)
    out = []
    for n in (300, 1, 257):
        x = (rng.lognormal(1.0, 2.0, n) * rng.choice([-1.0, 1.0], n)).astype(np.float32)
        x = _off_edges(x, gamma)
        if x.size > 2:
            x[1] = np.nan
            x[2] = 0.0
        out.append(x)
    return out


@pytest.mark.parametrize("bins,alpha", [(512, 0.01), (64, 0.05), (8, 0.2)])
def test_quantile_sketch_matches_jax(bins, alpha):
    jm = metrics_tpu.QuantileSketch(bins=bins, alpha=alpha)
    tm = metrics_tpu_torch.QuantileSketch(bins=bins, alpha=alpha, device="cpu")
    _drive(jm, tm, _quantile_stream(seed=bins, gamma=tm.gamma))
    batches = _quantile_stream(seed=bins + 1, gamma=tm.gamma)
    for x in batches:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jm.update(jnp.asarray(x))
            tm.update(_t(x))
    qs = np.array([0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0], np.float32)
    _assert_same(jm.quantile(jnp.asarray(qs)), tm.quantile(_t(qs)), exact=False)
    _assert_same(jm.quantile(0.7), tm.quantile(0.7), exact=False)


def test_quantile_sketch_bucket_edge_is_at_most_one_bucket_apart():
    # exact powers of gamma sit on bucket edges: the stated edge case
    tm = metrics_tpu_torch.QuantileSketch(device="cpu")
    jm = metrics_tpu.QuantileSketch()
    x = (tm.gamma ** np.arange(-200, 200, 7)).astype(np.float32)
    got = tm._index(_t(x)).numpy()
    ref = np.asarray(jm._index(jnp.asarray(x))).astype(np.int64)
    assert np.abs(got - ref).max() <= 1


def test_quantile_sketch_empty_is_nan_and_host_twin_matches_jax():
    tm = metrics_tpu_torch.QuantileSketch(device="cpu")
    assert torch.isnan(tm.quantile(0.5))
    values = [float(v) for v in _off_edges(np.linspace(-50.0, 120.0, 501).astype(np.float32), tm.gamma)] + [0.0, np.nan]
    jh, th = jax_sketch.HostQuantileSketch(), metrics_tpu_torch.HostQuantileSketch()
    jh.add_many(values)
    th.add_many(values)
    np.testing.assert_array_equal(th.counts, jh.counts)
    assert th.snapshot() == jh.snapshot() and th.nbytes == jh.nbytes
    dev = th.to_device("cpu")
    _assert_same(jh.to_device().value, dev.value, exact=True)
    _assert_same(jh.to_device().compute(), dev.compute(), exact=False)
    with pytest.raises(ValueError, match="different shapes"):
        th.merge(metrics_tpu_torch.HostQuantileSketch(bins=8))


@pytest.mark.parametrize("precision", [4, 10, 14])
def test_hyperloglog_matches_jax(precision):
    rng = np.random.RandomState(precision)
    batches = [(rng.randint(0, 3000, n) * 0.5).astype(np.float32) for n in (2000, 1, 700)]
    batches[0][::50] = np.nan
    batches[0][1] = -0.0
    batches[2][0] = 0.0
    jm = metrics_tpu.HyperLogLog(precision=precision)
    tm = metrics_tpu_torch.HyperLogLog(precision=precision, device="cpu")
    assert tm.value.dtype == torch.int32
    _drive(jm, tm, batches)


@pytest.mark.parametrize("depth,width", [(4, 1024), (2, 64), (5, 65536)])
def test_count_min_heavy_hitters_matches_jax(depth, width):
    rng = np.random.RandomState(depth + width)
    batches = [(rng.zipf(1.3, n) % 5000).astype(np.float32) for n in (3000, 1, 1000)]
    batches[0][::97] = np.nan
    batches[0][5] = -0.0
    weights = [rng.randint(1, 4, b.shape[0]).astype(np.float32) for b in batches]
    jm = metrics_tpu.CountMinHeavyHitters(depth=depth, width=width)
    tm = metrics_tpu_torch.CountMinHeavyHitters(depth=depth, width=width, device="cpu")
    _drive(jm, tm, batches, weights=weights, exact_values=True)
    keys = np.array([0.0, -0.0, 1.0, 2.0, 3.0, 17.0, 4999.0, 123456.0], np.float32)
    for x, w in zip(batches, weights):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jm.update(jnp.asarray(x), jnp.asarray(w))
            tm.update(_t(x), _t(w))
    _assert_same(jm.estimate(jnp.asarray(keys)), tm.estimate(_t(keys)), exact=True)
    _assert_same(jm.estimate(3.0), tm.estimate(3.0), exact=True)
    _assert_same(jm.compute(), tm.compute(), exact=True)
    # never an underestimate
    stream = np.concatenate(batches)
    wts = np.concatenate(weights)
    for k in (1.0, 2.0, 3.0):
        assert float(tm.estimate(k)) >= float(wts[stream == k].sum())


@pytest.mark.parametrize(
    "make",
    [lambda pkg, **d: pkg.QuantileSketch(bins=0, **d), lambda pkg, **d: pkg.QuantileSketch(alpha=1.0, **d),
     lambda pkg, **d: pkg.HyperLogLog(precision=3, **d), lambda pkg, **d: pkg.CountMinHeavyHitters(width=0, **d)],
    ids=["bins", "alpha", "precision", "width"],
)
def test_sketch_constructor_errors_match_jax(make):
    with pytest.raises(ValueError) as jax_err:
        make(metrics_tpu)
    with pytest.raises(ValueError) as torch_err:
        make(metrics_tpu_torch, device="cpu")
    assert str(jax_err.value) == str(torch_err.value)


def test_sketch_to_moves_the_seeds():
    tm = metrics_tpu_torch.CountMinHeavyHitters(depth=3, device="cpu")
    np.testing.assert_array_equal(tm._seeds().numpy().view(np.uint32), _seeds(3))
    tm.to("meta")
    assert tm._seeds().device.type == "meta" and tm.value.device.type == "meta"


# -------------------------------------------------------------- checkpoints
def test_sketch_state_dict_jax_to_port_to_jax():
    rng = np.random.RandomState(41)
    batches = [(rng.zipf(1.2, n) % 700).astype(np.float32) for n in (500, 300, 200)]
    jm = metrics_tpu.CountMinHeavyHitters(width=256)
    jm.persistent(True)
    for x in batches[:2]:
        jm.update(jnp.asarray(x))
    tm = metrics_tpu_torch.CountMinHeavyHitters(width=256, device="cpu")
    tm.persistent(True)
    load_jax_state_dict(tm, jm.state_dict())
    _assert_states(jm, tm)
    tm.update(_t(batches[2]))
    jm.update(jnp.asarray(batches[2]))
    jm2 = metrics_tpu.CountMinHeavyHitters(width=256)
    jm2.persistent(True)
    jm2.load_state_dict(to_jax_state_dict(tm))
    _assert_states(jm2, tm)
    _assert_states(jm, tm)
    assert {k: v for k, v in jm.state_dict().items() if k.startswith("__checksum__")} == {
        k: v for k, v in tm.state_dict().items() if k.startswith("__checksum__")
    }
