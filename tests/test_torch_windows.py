"""The port's streaming windows held against the JAX package on the CPU.

``SlidingWindow`` (slide 1 and 2), ``FoldTreeWindow``, ``ResolutionLadder``,
``TumblingWindow`` and ``ExponentialDecay`` around integer-count, float-sum,
mixed and sketch inner metrics get the same seeded numpy batches in both
packages (the float sums over positive values, whose float32 sums in another
order stay within the relative tolerance; a signed sum cancels), each with ``jit_update=False`` and ``True``. After every tick the
port's states must equal the JAX package's: integer states bit for bit,
float states to ``rtol=1e-6`` (``atol=1e-7`` for sums that cancel), NaN
equal, and so must the values. The port's engine path (on the CPU its
program runs directly under the traced flag: the refold, the cached read and
the cascades as selects) must equal its eager path bit for bit, state and
value, every tick.

Also here: masked ticks (a fully padded lane is a no-op), ``forward``'s batch
value, ``reset``, the geometry and inner-metric refusals with the JAX
package's messages, ``compute_range``'s merge counts, the ladder's cascades,
the prefix cache poisoned by a merge, checkpoints in both directions, and
``fused_window_tick`` on the CPU.

One reference fault is not copied (ROADMAP.md, Queue C): the JAX package's
``FoldTreeWindow`` drops its sparse table only in Python, which an engine's
cached program does not run, so with ``jit_update=True`` a range read after
later ticks returns the old table's value. The port keys the table on
``state_version``.
"""
import copy
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu_torch as M
from metrics_tpu import streaming as JS
from metrics_tpu_torch import streaming as TS
from metrics_tpu_torch.interop import load_jax_state_dict, to_jax_state_dict
from metrics_tpu_torch.ops import fused_window_tick, launches, reset_launches
from metrics_tpu_torch.streaming.window import _describe, _poison_token
from metrics_tpu_torch.utilities.checks import tracing
from metrics_tpu_torch.utilities.exceptions import MetricsUserError
from metrics_tpu.utilities.exceptions import MetricsUserError as JaxMetricsUserError

RTOL = 1e-6
ATOL_STATE = 1e-7
C = 5
TICKS = 13

# inner metric: (constructor, batch maker from a RandomState)
INNERS = {
    "accuracy": (lambda P, **kw: P.Accuracy(num_classes=C, average="macro", **kw),
                 lambda rng, b: (rng.rand(b, C).astype(np.float32), rng.randint(0, C, b).astype(np.int32))),
    "sum": (lambda P, **kw: P.SumMetric(**kw),
            lambda rng, b: ((rng.rand(b) * 3).astype(np.float32),)),
    "mse": (lambda P, **kw: P.MeanSquaredError(**kw),
            lambda rng, b: (rng.randn(b).astype(np.float32), rng.randn(b).astype(np.float32))),
    "countmin": (lambda P, **kw: P.CountMinHeavyHitters(depth=2, width=64, **kw),
                 lambda rng, b: (rng.zipf(1.3, b).clip(max=500).astype(np.float32),)),
    "hll": (lambda P, **kw: P.HyperLogLog(precision=6, **kw),
            lambda rng, b: (rng.randint(0, 1000, b).astype(np.float32),)),
    "quantile": (lambda P, **kw: P.QuantileSketch(bins=32, **kw),
                 lambda rng, b: (rng.lognormal(0.0, 1.0, b).astype(np.float32),)),
    "mean": (lambda P, **kw: P.MeanMetric(**kw),
             lambda rng, b: (rng.lognormal(0.0, 1.0, b).astype(np.float32),)),
}

# window: (JAX class, port class, kwargs, inner metrics it takes)
WINDOWS = {
    "sliding1": ("SlidingWindow", {"window": 4}, ("accuracy", "sum", "mse", "countmin", "hll", "quantile", "mean")),
    "sliding2": ("SlidingWindow", {"window": 6, "slide": 2}, ("accuracy", "sum", "mse", "countmin", "hll", "mean")),
    "foldtree": ("FoldTreeWindow", {"window": 4}, ("accuracy", "sum", "countmin", "hll")),
    "ladder": ("ResolutionLadder", {"levels": (3, 2, 2)}, ("accuracy", "sum", "mse", "countmin", "quantile")),
    "tumbling": ("TumblingWindow", {"window": 3}, ("accuracy", "sum", "mse", "countmin", "mean")),
    "decay": ("ExponentialDecay", {"halflife": 3.0}, ("accuracy", "sum", "mse", "mean")),
}
CASES = [(w, i) for w, (_, _, inners) in sorted(WINDOWS.items()) for i in inners]


def _t(x):
    return torch.from_numpy(np.array(x))


def _batches(inner, n=TICKS, seed=0, b=12):
    rng = np.random.RandomState(seed)
    make = INNERS[inner][1]
    return [make(rng, b) for _ in range(n)]


def _both(window, inner, jit):
    cls, kwargs, _ = WINDOWS[window]
    ctor = INNERS[inner][0]
    return (getattr(JS, cls)(ctor(J), jit_update=jit, **kwargs),
            getattr(TS, cls)(ctor(M, device="cpu"), jit_update=jit, **kwargs))


def _port(window, inner, jit):
    cls, kwargs, _ = WINDOWS[window]
    return getattr(TS, cls)(INNERS[inner][0](M, device="cpu"), jit_update=jit, **kwargs)


def _states_close(jw, tw, what):
    for k in tw._defaults:
        ref, got = np.asarray(getattr(jw, k)), getattr(tw, k).numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape, (what, k, got.dtype, ref.dtype, got.shape, ref.shape)
        if np.issubdtype(ref.dtype, np.floating):
            np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL_STATE, equal_nan=True, err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(got, ref, err_msg=f"{what} {k}")


def _value_close(got, ref, what):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0, equal_nan=True, err_msg=what)


def _bits_equal(a, b, what):
    """Two port windows (or values) equal bit for bit."""
    if isinstance(a, M.Metric):
        for k in a._defaults:
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype and torch.equal(x.view(-1).view(torch.uint8) if x.dtype.is_floating_point else x,
                                                     y.view(-1).view(torch.uint8) if y.dtype.is_floating_point else y), \
                f"{what} {k}"
        return
    assert torch.equal(torch.atleast_1d(a).view(torch.uint8), torch.atleast_1d(b).view(torch.uint8)), what


# ------------------------------------------------------------- parity grid
@pytest.mark.parametrize("jit", [False, True], ids=["eager", "engine"])
@pytest.mark.parametrize("window,inner", CASES)
def test_window_states_and_values_equal_jax_every_tick(window, inner, jit):
    jw, tw = _both(window, inner, jit)
    assert tw.device.type == "cpu"
    for step, batch in enumerate(_batches(inner)):
        jw.update(*(jnp.asarray(x) for x in batch))
        tw.update(*(_t(x) for x in batch))
        _states_close(jw, tw, f"tick {step}")
        _value_close(tw.compute(), jw.compute(), f"tick {step}")
    if jit:
        assert tw.dispatch_stats["retraces"] == 1 and tw.dispatch_stats["demotions"] == 0
    if window == "ladder":
        for level in range(3):
            _value_close(tw.compute_level(level), jw.compute_level(level), f"level {level}")
    if window == "foldtree":
        for lo, hi in ((0, 4), (1, 3), (2, 4), (3, 4)):
            _value_close(tw.compute_range(lo, hi), jw.compute_range(lo, hi), f"range {lo}:{hi}")
            assert tw.range_merge_count == jw.range_merge_count


@pytest.mark.parametrize("window,inner", CASES)
def test_engine_path_is_bit_equal_to_the_eager_path(window, inner):
    eager, engine = _port(window, inner, False), _port(window, inner, True)
    for step, batch in enumerate(_batches(inner, seed=1)):
        eager.update(*(_t(x) for x in batch))
        engine.update(*(_t(x) for x in batch))
        _bits_equal(engine, eager, f"tick {step}")
        _bits_equal(engine.compute(), eager.compute(), f"value at tick {step}")
    assert engine.dispatch_stats["dispatches"] == TICKS and engine.dispatch_stats["retraces"] == 1


# --------------------------------------------------------- masks, forward
@pytest.mark.parametrize("jit", [False, True], ids=["eager", "engine"])
@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_a_fully_padded_lane_is_a_noop(window, jit):
    tw = _port(window, "accuracy", jit)
    batches = _batches("accuracy", n=7, seed=2)
    for batch in batches[:5]:
        tw.update(*(_t(x) for x in batch))
    before = {k: getattr(tw, k).clone() for k in tw._defaults}
    p, t = (_t(x) for x in batches[5])
    tw._masked_update(torch.zeros(p.shape[0], dtype=torch.bool), p, t)
    for k, v in before.items():
        assert torch.equal(getattr(tw, k), v), k


@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_masked_ticks_equal_jax_and_the_traced_path(window):
    """A partly padded tick (rows past ``n`` masked) against the JAX
    package's ``_masked_update`` and against the port's traced run of it."""
    jw, tw = _both(window, "accuracy", False)
    traced = _port(window, "accuracy", False)
    for i, (p, t) in enumerate(_batches("accuracy", n=9, seed=3)):
        mask = np.arange(len(p)) < (len(p) - i % 4) if i % 3 else np.zeros(len(p), bool)
        jw._masked_update(jnp.asarray(mask), jnp.asarray(p), jnp.asarray(t))
        tw._masked_update(_t(mask), _t(p), _t(t))
        with tracing():
            traced._masked_update(_t(mask), _t(p), _t(t))
        _states_close(jw, tw, f"tick {i}")
        _bits_equal(traced, tw, f"traced tick {i}")


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "engine"])
@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_forward_batch_value_is_the_inner_metric_on_the_batch(window, jit):
    tw = _port(window, "accuracy", jit)
    jw, _ = _both(window, "accuracy", False)
    batches = _batches("accuracy", n=5, seed=4)
    for p, t in batches:
        got = tw.forward(_t(p), _t(t))
        fresh = M.Accuracy(num_classes=C, average="macro", device="cpu")
        fresh.update(_t(p), _t(t))
        if window == "decay":
            # the batch value decays a fresh (zero) state first: the same counts, scaled by nothing
            assert torch.allclose(got, fresh.compute(), rtol=RTOL, atol=0)
        else:
            _bits_equal(got, fresh.compute(), "forward")
        jw.update(jnp.asarray(p), jnp.asarray(t))
    _states_close(jw, tw, "after forward")


@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_reset_restores_the_defaults(window):
    tw = _port(window, "countmin", False) if window != "decay" else _port(window, "mse", False)
    inner = "countmin" if window != "decay" else "mse"
    for batch in _batches(inner, n=5, seed=5):
        tw.update(*(_t(x) for x in batch))
    tw.reset()
    for k, v in tw.default_state().items():
        assert torch.equal(getattr(tw, k), v), k


# ------------------------------------------------------------------ oracle
@pytest.mark.parametrize("jit", [False, True], ids=["eager", "engine"])
@pytest.mark.parametrize("inner", ["sum", "countmin", "accuracy"])
def test_sliding_window_equals_a_fresh_metric_fed_the_last_window(inner, jit):
    """slide=1: the value is bit-equal to a fresh inner metric fed exactly
    the last ``window`` updates (the fold adds exact defaults in stream order)."""
    window = 5
    tw = TS.SlidingWindow(INNERS[inner][0](M, device="cpu"), window=window, jit_update=jit)
    batches = _batches(inner, n=12, seed=6)
    for i, batch in enumerate(batches):
        tw.update(*(_t(x) for x in batch))
        oracle = INNERS[inner][0](M, device="cpu")
        for b in batches[max(0, i - window + 1): i + 1]:
            oracle.update(*(_t(x) for x in b))
        _bits_equal(tw.compute(), oracle.compute(), f"tick {i}")


@pytest.mark.parametrize("slide", [2, 3])
def test_sliding_window_slide_granularity_equals_its_bucket_oracle(slide):
    """slide > 1: integer states are exact under any grouping, so a fresh
    metric fed the updates of the buckets held agrees bit for bit."""
    n_buckets = 3
    tw = TS.SlidingWindow(INNERS["accuracy"][0](M, device="cpu"), window=n_buckets * slide, slide=slide,
                          jit_update=True)
    cursor, in_bucket, buckets = 0, 0, [[] for _ in range(n_buckets)]
    for p, t in _batches("accuracy", n=14, seed=7):
        if in_bucket >= slide:
            cursor, in_bucket = (cursor + 1) % n_buckets, 0
            buckets[cursor] = []
        buckets[cursor].append((p, t))
        in_bucket += 1
        tw.update(_t(p), _t(t))
        oracle = INNERS["accuracy"][0](M, device="cpu")
        for b in range(n_buckets):
            for pp, tt in buckets[b]:
                oracle.update(_t(pp), _t(tt))
        _bits_equal(tw.compute(), oracle.compute(), "bucket oracle")
        assert int(tw.cursor) == cursor and int(tw.in_bucket) == in_bucket


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "engine"])
def test_ladder_equals_one_streamed_metric_across_cascades(jit):
    """Integer counts: the whole-horizon value equals one metric fed every
    tick retained, at every tick, across the minute and hour cascades; each
    level equals a fresh metric fed its ticks."""
    levels = (3, 2, 2)
    tw = TS.ResolutionLadder(INNERS["accuracy"][0](M, device="cpu"), levels=levels, jit_update=jit)
    batches = _batches("accuracy", n=14, seed=8)
    for i, (p, t) in enumerate(batches):
        tw.update(_t(p), _t(t))
        # retained: level 0 holds the ticks since the last minute cascade, level 1 the completed minutes
        # since the last hour cascade, level 2 the completed hours
        oracle = INNERS["accuracy"][0](M, device="cpu")
        for pp, tt in batches[: i + 1]:
            oracle.update(_t(pp), _t(tt))
        _bits_equal(tw.compute(), oracle.compute(), f"tick {i}")
        minute = INNERS["accuracy"][0](M, device="cpu")
        for pp, tt in batches[(i // 3) * 3: i + 1]:
            minute.update(_t(pp), _t(tt))
        _bits_equal(tw.compute_level(0), minute.compute(), f"level 0 at tick {i}")
    assert int(tw.ticks) == len(batches) and int(tw.lvl2_counts.sum()) == 12


def test_ladder_masked_tick_advances_and_cascades_nothing():
    tw = TS.ResolutionLadder(INNERS["accuracy"][0](M, device="cpu"), levels=(2, 2), jit_update=False)
    jw = JS.ResolutionLadder(INNERS["accuracy"][0](J), levels=(2, 2), jit_update=False)
    batches = _batches("accuracy", n=3, seed=15)
    for p, t in batches[:2]:
        tw.update(_t(p), _t(t))
        jw.update(jnp.asarray(p), jnp.asarray(t))
    before = {k: getattr(tw, k).clone() for k in tw._defaults}
    p, t = batches[2]
    # t == 2: a live tick would cascade level 0 into level 1 first
    tw._masked_update(torch.zeros(len(p), dtype=torch.bool), _t(p), _t(t))
    jw._masked_update(jnp.zeros(len(p), bool), jnp.asarray(p), jnp.asarray(t))
    for k, v in before.items():
        assert torch.equal(getattr(tw, k), v), k
    _states_close(jw, tw, "masked tick")


def test_tumbling_semantics_and_decay_closed_form():
    w = TS.TumblingWindow(M.SumMetric(device="cpu"), window=2, jit_update=False)
    for v, want in ((1.0, 1.0), (2.0, 3.0), (4.0, 3.0), (8.0, 12.0)):
        w.update(torch.tensor(v))
        assert float(w.compute()) == want
    m = TS.ExponentialDecay(M.MeanMetric(device="cpu"), halflife=10.0, jit_update=True)
    d = 0.5 ** (1.0 / 10.0)
    num = den = 0.0
    for v in (1.0, 2.0, 3.0, -1.0):
        m.update(torch.tensor(v))
        num, den = d * num + v, d * den + 1.0
    np.testing.assert_allclose(float(m.compute()), num / den, rtol=RTOL)


@pytest.mark.parametrize("inner", ["accuracy", "mse"])
def test_decay_holds_integer_states_as_float32_like_jax(inner):
    """The integer counts added into float32 states (int32 + float32 gives
    float32 in both packages) after a float32 multiply: the JAX package's
    eager bits for every state the inner metric holds as an integer (its
    engine may contract the multiply and add into one rounding; the port's
    engine keeps the eager path's bits). Float inner states differ by their
    own batch sums' order: rtol 1e-6."""
    jw, tw = _both("decay", inner, False)
    promoted = [f"ew_{k}" for k, d in tw._inner._defaults.items() if not d.is_floating_point()]
    assert promoted and all(getattr(tw, k).dtype == torch.float32 for k in tw._defaults)
    for batch in _batches(inner, n=6, seed=9):
        jw.update(*(jnp.asarray(x) for x in batch))
        tw.update(*(_t(x) for x in batch))
        for k in promoted:
            np.testing.assert_array_equal(getattr(tw, k).numpy(), np.asarray(getattr(jw, k)), err_msg=k)
        _states_close(jw, tw, "decayed")


# ------------------------------------------------------------- fold tree
def test_compute_range_merge_counts_and_values_equal_jax_and_the_oracle():
    n = 8
    jw = JS.FoldTreeWindow(J.SumMetric(), window=n, jit_update=False)
    tw = TS.FoldTreeWindow(M.SumMetric(device="cpu"), window=n, jit_update=False)
    ticks = [np.float32(2.0 ** i) for i in range(11)]
    for v in ticks:
        jw.update(jnp.asarray(v))
        tw.update(torch.tensor(v))
    for lo in range(n):
        for hi in range(lo + 1, n + 1):
            got = tw.compute_range(lo, hi)
            _value_close(got, jw.compute_range(lo, hi), f"range {lo}:{hi}")
            assert tw.range_merge_count == jw.range_merge_count <= math.ceil(math.log2(n))
            # logical bucket j is tick T - n + j
            assert float(got) == float(sum(ticks[len(ticks) - n + lo: len(ticks) - n + hi]))
    assert tw.tree_builds == 1
    tw.compute_range(0, n)
    assert tw.range_merge_count == 1


def test_fold_tree_rebuilds_after_engine_ticks_where_jax_reads_a_stale_table():
    jw = JS.FoldTreeWindow(J.SumMetric(), window=4, jit_update=True)
    tw = TS.FoldTreeWindow(M.SumMetric(device="cpu"), window=4, jit_update=True)
    for v in (1.0, 2.0):
        jw.update(jnp.asarray(v))
        tw.update(torch.tensor(v))
    assert float(tw.compute_range(0, 4)) == float(jw.compute_range(0, 4)) == 3.0
    for v in (4.0, 8.0):
        jw.update(jnp.asarray(v))
        tw.update(torch.tensor(v))
    assert float(tw.compute_range(0, 4)) == float(tw.compute()) == 15.0 and tw.tree_builds == 2
    # the reference's engine never ran the Python that drops its table
    assert float(jw.compute_range(0, 4)) == 3.0 and float(jw.compute()) == 15.0


# ---------------------------------------------------------- refusals
@pytest.mark.parametrize("make,match", [
    (lambda P, kw: P.SlidingWindow(P.SumMetric(**kw), window=5, slide=2), "positive multiple"),
    (lambda P, kw: P.SlidingWindow(P.SumMetric(**kw), window=0), "positive multiple"),
    (lambda P, kw: P.ResolutionLadder(P.SumMetric(**kw), levels=(4, 1)), "levels must be ring sizes"),
    (lambda P, kw: P.ResolutionLadder(P.SumMetric(**kw), levels=()), "levels must be ring sizes"),
    (lambda P, kw: P.TumblingWindow(P.SumMetric(**kw), window=0), "window must be positive"),
    (lambda P, kw: P.ExponentialDecay(P.SumMetric(**kw), halflife=0.0), "halflife must be positive"),
    (lambda P, kw: P.SlidingWindow(P.CatMetric(**kw), window=4), "list state"),
    (lambda P, kw: P.ExponentialDecay(P.MaxMetric(**kw), halflife=4.0), "max/min"),
    (lambda P, kw: P.TumblingWindow(lambda: None, window=4), "expects a Metric"),
])
def test_geometry_and_inner_refusals_match_jax(make, match):
    class NS:
        pass

    for pkg, mod, kw, err in ((J, JS, {}, JaxMetricsUserError), (M, TS, {"device": "cpu"}, MetricsUserError)):
        ns = NS()
        for name in ("SumMetric", "CatMetric", "MaxMetric"):
            setattr(ns, name, getattr(pkg, name))
        for name in ("SlidingWindow", "ResolutionLadder", "TumblingWindow", "ExponentialDecay"):
            setattr(ns, name, getattr(mod, name))
        with pytest.raises(err, match=match):
            make(ns, kw)


def test_fold_tree_refuses_a_running_mean_inner_like_jax():
    class MeanState(M.Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("avg", torch.tensor(0.0), dist_reduce_fx="mean")

        def update(self, x):
            self.avg = self.avg + x.mean()

        def compute(self):
            return self.avg

    with pytest.raises(MetricsUserError, match="running-mean reduction, which is not"):
        TS.FoldTreeWindow(MeanState(device="cpu"), window=4)
    with pytest.raises(JaxMetricsUserError, match="running-mean reduction, which is not"):
        JS.FoldTreeWindow(J.PeakSignalNoiseRatio(data_range=1.0), window=4)


def test_window_takes_its_inner_metric_device_and_refuses_another():
    inner = M.SumMetric(device="cpu")
    assert TS.SlidingWindow(inner, window=2).device.type == "cpu"
    assert TS.SlidingWindow(inner, window=2, device="cpu").device.type == "cpu"
    with pytest.raises(MetricsUserError, match="cannot wrap a metric on cpu"):
        TS.SlidingWindow(inner, window=2, device="meta")
    w = TS.ExponentialDecay(M.MeanMetric(device="cpu"), halflife=2.0).to("cpu")
    assert all(v.device.type == "cpu" for v in w._inner_defaults.values()) and w._decay_factor.device.type == "cpu"


def test_inner_spec_distinguishes_configs():
    a = TS.SlidingWindow(M.Accuracy(num_classes=4, average="macro", device="cpu"), window=4)
    b = TS.SlidingWindow(M.Accuracy(num_classes=8, average="macro", device="cpu"), window=4)
    assert a.inner_spec != b.inner_spec and a.inner_spec == _describe(a._inner)
    assert "tp:(4,)/int32" in a.inner_spec and repr(a) == "SlidingWindow(Accuracy())"


# ------------------------------------------------------ prefix cache, sync
def test_a_merge_poisons_the_prefix_cache_and_the_next_read_rebuilds():
    batches = _batches("accuracy", n=9, seed=10)
    a, b = (TS.SlidingWindow(INNERS["accuracy"][0](M, device="cpu"), window=4, jit_update=False) for _ in range(2))
    ja, jb = (JS.SlidingWindow(INNERS["accuracy"][0](J), window=4, jit_update=False) for _ in range(2))
    for i, (p, t) in enumerate(batches):
        (a if i % 2 else b).update(_t(p), _t(t))
        (ja if i % 2 else jb).update(jnp.asarray(p), jnp.asarray(t))
    assert int(_poison_token(torch.stack([a.pfx_token, b.pfx_token]))) == -1
    # the merged state: counts summed, cursors reconciled, the token poisoned
    merged, jmerged = a.pure_merge(a.state(), b.state()), ja.pure_merge(ja.state(), jb.state())
    assert int(merged["pfx_token"]) == -1
    for k, v in merged.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jmerged[k]), err_msg=k)
    eager_value = a.pure_compute(merged)
    with tracing():
        traced_value = a.pure_compute(merged)
    _bits_equal(traced_value, eager_value, "poisoned read, traced against eager")
    _value_close(eager_value, ja.pure_compute(jmerged), "poisoned read")
    # an eager read repairs the cache of the state it read
    a._load_state(merged)
    a._computed = None
    a.compute()
    assert int(a.pfx_token) == int(a.advances) >= 0


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_window_checkpoints_cross_between_packages_both_ways(window):
    inner = "accuracy"
    jw, tw = _both(window, inner, False)
    batches = _batches(inner, n=12, seed=12)
    for batch in batches[:7]:
        jw.update(*(jnp.asarray(x) for x in batch))
    jw.persistent(True)
    load_jax_state_dict(tw, jw.state_dict())
    _states_close(jw, tw, "jax -> port")
    for batch in batches[7:]:
        jw.update(*(jnp.asarray(x) for x in batch))
        tw.update(*(_t(x) for x in batch))
        _states_close(jw, tw, "resumed")
    tw.persistent(True)
    back, _ = _both(window, inner, False)
    back.load_state_dict(to_jax_state_dict(tw))
    _states_close(back, tw, "port -> jax")
    _value_close(tw.compute(), back.compute(), "port -> jax")


# ----------------------------------------------------------- fused tick
@pytest.mark.parametrize("inner", ["accuracy", "countmin"])
def test_fused_window_tick_on_the_cpu_equals_the_eager_tick(inner):
    eager = TS.SlidingWindow(INNERS[inner][0](M, device="cpu"), window=4, slide=2, jit_update=False)
    fused = TS.SlidingWindow(INNERS[inner][0](M, device="cpu"), window=4, slide=2, jit_update=False)
    reset_launches()
    for i, batch in enumerate(_batches(inner, n=9, seed=13)):
        eager.update(*(_t(x) for x in batch))
        assert fused_window_tick(fused, tuple(_t(x) for x in batch), {}) is True
        _bits_equal(fused, eager, f"tick {i}")
        _bits_equal(fused.compute(), eager.compute(), f"value at tick {i}")
    assert all(n == 0 for n in launches().values())  # the CPU runs the kernels' plain versions
    stats = fused.dispatch_stats
    assert stats["dispatches"] == 9 and stats["retraces"] == 1 and fused._update_count == 9
    # a copy captures its own tick engine
    twin = copy.deepcopy(fused)
    assert twin._fused_tick is None and fused._fused_tick is not None
    twin.to("cpu")
    assert twin._fused_tick is None


def test_fused_window_tick_keys_programs_by_input_shape():
    w = TS.SlidingWindow(INNERS["sum"][0](M, device="cpu"), window=3, jit_update=False)
    for b in (4, 4, 9, 4, 9):  # SumMetric has no masked update: a program each shape
        fused_window_tick(w, (torch.ones(b),), {})
    assert w.dispatch_stats["retraces"] == 2 and w.dispatch_stats["dispatches"] == 5
    assert float(w.compute()) == 9 + 4 + 9


@pytest.mark.parametrize("window", ["sliding1", "ladder"])
def test_many_engine_ticks_build_one_program_of_fixed_leaves(window):
    tw = _port(window, "accuracy", True)
    shapes = {k: (v.shape, v.dtype) for k, v in tw.default_state().items()}
    p, t = (_t(x) for x in _batches("accuracy", n=1, seed=14)[0])
    for _ in range(200):
        tw.update(p, t)
    assert tw.dispatch_stats["dispatches"] == 200 and tw.dispatch_stats["retraces"] == 1
    assert {k: (getattr(tw, k).shape, getattr(tw, k).dtype) for k in tw._defaults} == shapes
