"""The port's wrappers held against the JAX package on the CPU.

``BootStrapper``, ``ClasswiseWrapper``, ``MinMaxMetric``,
``MultioutputWrapper`` and ``MetricTracker`` get the same seeded numpy inputs
in both packages. Integer states and the resample copies' integer states must
be equal bit for bit (the two packages draw the same indices from one seeded
``RandomState``); float states and values agree to ``rtol=1e-6`` (float32
sums in another order; ``quantile`` and ``std`` from ``torch.quantile`` and
``std(correction=1)`` against ``jnp.quantile`` and ``std(ddof=1)``), NaN
equal; float states also within ``atol=1e-7`` (``ATOL_STATE``: Pearson's
running means of zero-mean columns are sums that cancel to ~1e-3, where
float32 rounding in another order moves the fifth digit). Where the JAX package raises, the port raises the same type with the
same message.

One reference fault is not copied (ROADMAP.md, Queue C): the JAX package's
``forward`` of a wrapper resets the wrapped metrics and keeps only the batch,
so a ``compute`` after ``forward`` sees the last batch alone. The port's
``forward`` returns the JAX package's batch value and keeps the accumulated
state, which is held against the JAX package's update path.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu_torch as M
from metrics_tpu.wrappers.bootstrapping import _bootstrap_sampler as jax_sampler
from metrics_tpu_torch.interop import load_jax_state_dict, to_jax_state_dict
from metrics_tpu_torch.wrappers.bootstrapping import _bootstrap_sampler

RTOL = 1e-6
ATOL_STATE = 1e-7
C = 5


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, what=""):
    """Port value ``got`` against JAX value ``ref``: integers exactly, floats to RTOL, NaN equal."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), (what, sorted(got), sorted(ref))
        for k in ref:
            _close(got[k], ref[k], f"{what}.{k}")
        return
    if isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            _close(g, r, f"{what}[{i}]")
        return
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if np.issubdtype(ref.dtype, np.floating):
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0, equal_nan=True, err_msg=what)
    else:
        np.testing.assert_array_equal(got, ref, err_msg=what)


def _best_equal(got, ref):
    """``best_metric`` results: the same steps, the values to RTOL."""
    if isinstance(ref, tuple):
        _best_equal(got[0], ref[0])
        assert got[1] == ref[1]
    elif isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            _best_equal(got[k], ref[k])
    else:
        assert (got is None) == (ref is None) and (ref is None or np.isclose(got, ref, rtol=RTOL, atol=0))


def _states_equal(jm, tm, exact_floats=False):
    for k in tm._defaults:
        ref, got = np.asarray(getattr(jm, k)), getattr(tm, k).numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape, k
        if np.issubdtype(ref.dtype, np.floating) and not exact_floats:
            np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL_STATE, equal_nan=True, err_msg=k)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=k)


def _cls_batches(seed, n=4, b=24):
    rng = np.random.RandomState(seed)
    return [(rng.rand(b, C).astype(np.float32), rng.randint(0, C, b).astype(np.int32)) for _ in range(n)]


def _reg_batches(seed, n=4, b=24, outputs=None):
    rng = np.random.RandomState(seed)
    shape = (b,) if outputs is None else (b, outputs)
    out = []
    for _ in range(n):
        target = rng.randn(*shape).astype(np.float32)
        out.append(((target + 0.3 * rng.randn(*shape)).astype(np.float32), target))
    return out


def _pair(name, **kwargs):
    return getattr(J, name)(**kwargs), getattr(M, name)(device="cpu", **kwargs)


# ------------------------------------------------------------ BootStrapper
@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
@pytest.mark.parametrize("size", [1, 7, 50])
def test_bootstrap_sampler_draws_the_jax_indices(strategy, size):
    a, b = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(10):
        ref, got = np.asarray(jax_sampler(size, strategy, rng=a)), _bootstrap_sampler(size, strategy, rng=b)
        assert got.dtype == torch.int64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), ref)


def test_bootstrap_sampler_refuses_an_unknown_strategy_like_jax():
    for fn in (jax_sampler, _bootstrap_sampler):
        with pytest.raises(ValueError, match="Unknown sampling strategy"):
            fn(5, "bad", rng=np.random.RandomState(0))


def _bootstrappers(base, strategy, seed, **kwargs):
    jb = J.BootStrapper(getattr(J, base[0])(**base[1]), sampling_strategy=strategy, **kwargs)
    tb = M.BootStrapper(getattr(M, base[0])(device="cpu", **base[1]), sampling_strategy=strategy, **kwargs)
    jb._rng, tb._rng = np.random.RandomState(seed), np.random.RandomState(seed)
    return jb, tb


BOOT_BASES = {
    "accuracy_macro": (("Accuracy", {"num_classes": C, "average": "macro"}), _cls_batches),
    "mse": (("MeanSquaredError", {}), _reg_batches),
    "mean": (("MeanMetric", {}), lambda seed: [(p,) for p, _ in _reg_batches(seed)]),
}


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
@pytest.mark.parametrize("base", sorted(BOOT_BASES))
@pytest.mark.parametrize("quantile", [None, 0.9, (0.025, 0.975)])
def test_bootstrapper_copies_and_statistics_equal_jax(strategy, base, quantile):
    spec, data = BOOT_BASES[base]
    q = None if quantile is None else (np.float32(quantile) if isinstance(quantile, float) else np.asarray(quantile, np.float32))
    jb, tb = _bootstrappers(spec, strategy, seed=11, num_bootstraps=6, raw=True,
                            quantile=None if q is None else jnp.asarray(q))
    tb.quantile = None if q is None else _t(q)
    for batch in data(5):
        jb.update(*(jnp.asarray(x) for x in batch))
        tb.update(*(_t(x) for x in batch))
    for jm, tm in zip(jb.metrics, tb.metrics):
        # the copies saw the same rows: integer states bit-equal, float sums to RTOL
        _states_equal(jm, tm)
    ref, got = jb.compute(), tb.compute()
    assert set(got) == ({"mean", "std", "raw"} | ({"quantile"} if q is not None else set()))
    _close(got, ref, base)


def test_bootstrapper_errors_match_jax():
    for pkg, kw in ((J, {}), (M, {"device": "cpu"})):
        with pytest.raises(ValueError, match="sampling_strategy"):
            pkg.BootStrapper(pkg.MeanSquaredError(**kw), sampling_strategy="bad")
        with pytest.raises(ValueError, match="Expected base metric to be an instance of Metric"):
            pkg.BootStrapper(lambda x: x)
        b = pkg.BootStrapper(pkg.MeanMetric(**kw), num_bootstraps=2)
        with pytest.raises(ValueError, match="None of the input contained tensors"):
            b.update(x=1.0)


def test_bootstrapper_reset_and_device():
    tb = M.BootStrapper(M.MeanMetric(device="cpu"), num_bootstraps=3)
    assert tb.device.type == "cpu" and all(m.device.type == "cpu" for m in tb.metrics)
    tb.update(_t(np.arange(8, dtype=np.float32)))
    tb.reset()
    for m in tb.metrics:
        assert float(m.value) == 0.0 and float(m.weight) == 0.0


def test_bootstrapper_forward_returns_jax_batch_value_and_keeps_the_state():
    """JAX's forward draws 2B resamples (its update, then the batch update
    after a reset) and keeps the second; the port draws the same 2B, returns
    the same batch value and keeps the first, which the JAX package's update
    path holds after one update with the same seed."""
    spec, data = BOOT_BASES["accuracy_macro"]
    batch = data(7)[0]
    jb, tb = _bootstrappers(spec, "multinomial", seed=5, num_bootstraps=4)
    _close(tb.forward(*(_t(x) for x in batch)), jb.forward(*(jnp.asarray(x) for x in batch)), "forward")
    ju, _ = _bootstrappers(spec, "multinomial", seed=5, num_bootstraps=4)
    ju.update(*(jnp.asarray(x) for x in batch))
    for jm, tm in zip(ju.metrics, tb.metrics):
        _states_equal(jm, tm)


# -------------------------------------------------------- ClasswiseWrapper
@pytest.mark.parametrize("labels", [None, ["a", "b", "c", "d", "e"]])
@pytest.mark.parametrize("name,kwargs", [("Accuracy", {"average": "none"}), ("Precision", {"average": "none"}),
                                         ("Recall", {"average": None})])
def test_classwise_values_equal_jax(labels, name, kwargs):
    jw = J.ClasswiseWrapper(getattr(J, name)(num_classes=C, **kwargs), labels=labels)
    tw = M.ClasswiseWrapper(getattr(M, name)(num_classes=C, device="cpu", **kwargs), labels=labels)
    assert tw.device.type == "cpu"
    for p, t in _cls_batches(2, n=3):
        jw.update(jnp.asarray(p), jnp.asarray(t))
        tw.update(_t(p), _t(t))
    ref, got = jw.compute(), tw.compute()
    assert list(got) == [f"{name.lower()}_{lab}" for lab in (labels or range(C))]
    _close(got, ref)
    tw.reset()
    assert int(tw.metric.tp.sum()) == 0


def test_classwise_forward_returns_jax_batch_values_and_keeps_the_state():
    batches = _cls_batches(4, n=3)
    jw = J.ClasswiseWrapper(J.Accuracy(num_classes=C, average="none"))
    tw = M.ClasswiseWrapper(M.Accuracy(num_classes=C, average="none", device="cpu"))
    ju = J.ClasswiseWrapper(J.Accuracy(num_classes=C, average="none"))
    for p, t in batches:
        _close(tw(_t(p), _t(t)), jw(jnp.asarray(p), jnp.asarray(t)), "forward")
        ju.update(jnp.asarray(p), jnp.asarray(t))
    # the JAX package's forward kept the last batch only; the port the whole epoch (its update path)
    _close(tw.compute(), ju.compute(), "epoch")
    assert tw._update_count == len(batches)


def test_classwise_errors_match_jax():
    for pkg in (J, M):
        with pytest.raises(ValueError, match="Expected argument `metric` to be an instance of `Metric`"):
            pkg.ClasswiseWrapper(lambda x: x)
        inner = pkg.Accuracy(num_classes=C, average="none", **({} if pkg is J else {"device": "cpu"}))
        with pytest.raises(ValueError, match="Expected argument `labels` to either be `None` or a list of strings"):
            pkg.ClasswiseWrapper(inner, labels=["a", 1])


@pytest.mark.parametrize("prefix,postfix", [(None, None), ("val_", None), (None, "_ep"), ("val_", "_ep")])
def test_classwise_in_a_collection_with_prefix_and_postfix_equals_jax(prefix, postfix):
    def members(pkg, **kw):
        return [pkg.ClasswiseWrapper(pkg.Accuracy(num_classes=C, average="none", **kw), labels=list("vwxyz")),
                pkg.Accuracy(num_classes=C, average="macro", **kw)]

    jc = J.MetricCollection(members(J), prefix=prefix, postfix=postfix)
    tc = M.MetricCollection(members(M, device="cpu"), prefix=prefix, postfix=postfix)
    for p, t in _cls_batches(6, n=3):
        _close(tc(_t(p), _t(t)), jc(jnp.asarray(p), jnp.asarray(t)), "forward")
    ju = J.MetricCollection(members(J), prefix=prefix, postfix=postfix)
    for p, t in _cls_batches(6, n=3):
        ju.update(jnp.asarray(p), jnp.asarray(t))
    _close(tc.compute(), ju.compute(), "compute")


@pytest.mark.parametrize("member", ["classwise", "window"])
def test_wrapper_members_of_a_fused_collection_are_served_eagerly(member):
    """A member with child metrics holds state outside ``_defaults``: the
    fused collection falls back to its eager loop (``collections.py:297``, as
    ``metrics_tpu/collections.py:287``), with the eager collection's values."""

    def make(fused):
        inner = M.Accuracy(num_classes=C, average="none" if member == "classwise" else "macro", device="cpu")
        wrapped = (M.ClasswiseWrapper(inner) if member == "classwise"
                   else M.SlidingWindow(inner, window=2, jit_update=False))
        return M.MetricCollection({"w": wrapped, "acc": M.Accuracy(num_classes=C, device="cpu")},
                                  fused_update=fused, compute_groups=False)

    fused, eager = make(True), make(False)
    for p, t in _cls_batches(8, n=4):
        fused.update(_t(p), _t(t))
        eager.update(_t(p), _t(t))
    assert fused._fuse_failed and fused._dispatcher is None
    got, ref = fused.compute(), eager.compute()
    assert list(got) == list(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]) or (torch.isnan(got[k]).all() and torch.isnan(ref[k]).all()), k


# ---------------------------------------------------------- MinMaxMetric
@pytest.mark.parametrize("base", ["mean", "accuracy"])
def test_minmax_tracks_like_jax(base):
    if base == "mean":
        jm, tm = J.MinMaxMetric(J.MeanMetric()), M.MinMaxMetric(M.MeanMetric(device="cpu"))
        steps = [(np.float32(v),) for v in (2.0, 4.0, -1.0, 7.5, 0.25)]
    else:
        jm = J.MinMaxMetric(J.Accuracy(num_classes=C, average="macro"))
        tm = M.MinMaxMetric(M.Accuracy(num_classes=C, average="macro", device="cpu"))
        steps = _cls_batches(9, n=5)
    for batch in steps:
        jm.update(*(jnp.asarray(x) for x in batch))
        tm.update(*(_t(x) for x in batch))
        _close(tm.compute(), jm.compute())
    jm.reset()
    tm.reset()
    assert float(tm.min_val) == float("inf") and float(tm.max_val) == float("-inf")
    _close(tm.min_val, jm.min_val)
    _close(tm.max_val, jm.max_val)


def test_minmax_forward_returns_jax_batch_values_and_keeps_the_state():
    jm, tm, ju = J.MinMaxMetric(J.MeanMetric()), M.MinMaxMetric(M.MeanMetric(device="cpu")), J.MinMaxMetric(J.MeanMetric())
    for v in (2.0, 4.0, -3.0):
        _close(tm(torch.tensor(v)), jm(jnp.asarray(v)), "forward")
        ju.update(jnp.asarray(v))
    _close(tm.compute(), ju.compute(), "compute")
    assert float(tm.compute()["raw"]) == 1.0


def test_minmax_errors_match_jax_and_attributes_follow_the_device():
    for pkg, kw in ((J, {}), (M, {"device": "cpu"})):
        with pytest.raises(ValueError, match="Expected base metric to be an instance of `Metric`"):
            pkg.MinMaxMetric(lambda x: x)
        m = pkg.MinMaxMetric(pkg.Accuracy(num_classes=C, average="none", **kw))
        p, t = _cls_batches(1, n=1)[0]
        m.update(*((jnp.asarray(p), jnp.asarray(t)) if pkg is J else (_t(p), _t(t))))
        with pytest.raises(RuntimeError, match="Returned value from base metric should be a scalar"):
            m.compute()
    tm = M.MinMaxMetric(M.MeanMetric(device="cpu"))
    assert M.MinMaxMetric._device_attributes == ("min_val", "max_val")
    assert tm.device.type == "cpu" and tm.to("cpu").min_val.device.type == "cpu"
    assert M.MinMaxMetric._is_suitable_val(3) and M.MinMaxMetric._is_suitable_val(torch.ones(1))
    assert not M.MinMaxMetric._is_suitable_val(torch.ones(2)) and not M.MinMaxMetric._is_suitable_val("x")


# ------------------------------------------------------- MultioutputWrapper
@pytest.mark.parametrize("name", ["R2Score", "MeanSquaredError", "PearsonCorrCoef"])
@pytest.mark.parametrize("nan_rows", [False, True])
@pytest.mark.parametrize("remove_nans", [True, False])
def test_multioutput_equals_jax(name, nan_rows, remove_nans):
    jw = J.MultioutputWrapper(getattr(J, name)(), 3, remove_nans=remove_nans)
    tw = M.MultioutputWrapper(getattr(M, name)(device="cpu"), 3, remove_nans=remove_nans)
    assert tw.device.type == "cpu" and len(tw.metrics) == 3
    rng = np.random.RandomState(13)
    for i, (p, t) in enumerate(_reg_batches(3, n=3, outputs=3)):
        if nan_rows:
            p[rng.rand(len(p)) < 0.2, rng.randint(0, 3)] = np.nan
            t[rng.rand(len(t)) < 0.1, rng.randint(0, 3)] = np.nan
        if i == 0:
            _close(tw(_t(p), _t(t)), jw(jnp.asarray(p), jnp.asarray(t)), "forward")
        else:
            jw.update(jnp.asarray(p), jnp.asarray(t))
            tw.update(_t(p), _t(t))
    for jm, tm in zip(jw.metrics, tw.metrics):
        _states_equal(jm, tm)
    _close(tw.compute(), jw.compute())
    tw.reset()
    assert all(m._update_count == 0 for m in tw.metrics)


@pytest.mark.parametrize("output_dim,squeeze", [(0, True), (1, False)])
def test_multioutput_output_dim_and_squeeze_equal_jax(output_dim, squeeze):
    rng = np.random.RandomState(21)
    jw = J.MultioutputWrapper(J.MeanAbsoluteError(), 2, output_dim=output_dim, squeeze_outputs=squeeze)
    tw = M.MultioutputWrapper(M.MeanAbsoluteError(device="cpu"), 2, output_dim=output_dim, squeeze_outputs=squeeze)
    shape = (2, 16) if output_dim == 0 else (16, 2)
    for _ in range(2):
        p, t = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
        jw.update(jnp.asarray(p), jnp.asarray(t))
        tw.update(_t(p), _t(t))
    _close(tw.compute(), jw.compute())


# ------------------------------------------------------------ MetricTracker
@pytest.mark.parametrize("maximize", [True, False])
def test_tracker_over_a_metric_equals_jax(maximize):
    jt = J.MetricTracker(J.Accuracy(num_classes=C, average="macro"), maximize=maximize)
    tt = M.MetricTracker(M.Accuracy(num_classes=C, average="macro", device="cpu"), maximize=maximize)
    for epoch in range(4):
        jt.increment()
        tt.increment()
        for p, t in _cls_batches(30 + epoch, n=2):
            _close(tt(_t(p), _t(t)), jt(jnp.asarray(p), jnp.asarray(t)), "forward")
            jt.update(jnp.asarray(p), jnp.asarray(t))
            tt.update(_t(p), _t(t))
        _close(tt.compute(), jt.compute(), "compute")
    assert len(tt) == tt.n_steps == 4 and isinstance(tt[0], M.Accuracy)
    _close(tt.compute_all(), jt.compute_all(), "compute_all")
    _best_equal(tt.best_metric(), jt.best_metric())
    _best_equal(tt.best_metric(return_step=True), jt.best_metric(return_step=True))
    tt.reset()
    assert int(tt[-1].tp.sum()) == 0 and int(tt[0].tp.sum()) > 0
    tt.reset_all()
    assert int(tt[0].tp.sum()) == 0


@pytest.mark.parametrize("maximize", [True, [True, False, True]])
def test_tracker_over_a_collection_equals_jax(maximize):
    def coll(pkg, **kw):
        return pkg.MetricCollection({"acc": pkg.Accuracy(num_classes=C, average="macro", **kw),
                                     "mse": pkg.MeanSquaredError(**kw),
                                     "f1": pkg.F1Score(num_classes=C, average="macro", **kw)})

    jt, tt = J.MetricTracker(coll(J), maximize=maximize), M.MetricTracker(coll(M, device="cpu"), maximize=maximize)
    rng = np.random.RandomState(40)
    for _ in range(3):
        jt.increment()
        tt.increment()
        p = rng.randint(0, C, 32).astype(np.int32)
        t = rng.randint(0, C, 32).astype(np.int32)
        # MeanSquaredError takes the labels as floats: one input for all three members
        jt.update(jnp.asarray(p), jnp.asarray(t))
        tt.update(_t(p), _t(t))
    _close(tt.compute_all(), jt.compute_all(), "compute_all")
    _best_equal(tt.best_metric(), jt.best_metric())
    _best_equal(tt.best_metric(return_step=True), jt.best_metric(return_step=True))


def test_tracker_best_metric_is_none_with_a_warning_like_jax():
    for pkg, kw in ((J, {}), (M, {"device": "cpu"})):
        tracker = pkg.MetricTracker(pkg.Accuracy(num_classes=C, average="none", **kw))
        for p, t in _cls_batches(3, n=2):
            tracker.increment()
            tracker.update(*((jnp.asarray(p), jnp.asarray(t)) if pkg is J else (_t(p), _t(t))))
        with pytest.warns(UserWarning, match="Returning `None` instead"):
            assert tracker.best_metric() is None
        with pytest.warns(UserWarning, match="Returning `None` instead"):
            assert tracker.best_metric(return_step=True) == (None, None)
        coll = pkg.MetricTracker(pkg.MetricCollection([pkg.Accuracy(num_classes=C, average="none", **kw)]))
        coll.increment()
        coll.update(*((jnp.asarray(p), jnp.asarray(t)) if pkg is J else (_t(p), _t(t))))
        with pytest.warns(UserWarning, match="Returning `None` instead"):
            assert coll.best_metric(return_step=True) == ({"Accuracy": None}, {"Accuracy": None})


def test_tracker_errors_match_jax():
    for pkg, kw in ((J, {}), (M, {"device": "cpu"})):
        with pytest.raises(TypeError, match="Metric arg need to be an instance of a Metric or MetricCollection"):
            pkg.MetricTracker(lambda x: x)
        with pytest.raises(ValueError, match="should either be a single bool or list of bool"):
            pkg.MetricTracker(pkg.MeanMetric(**kw), maximize="yes")
        with pytest.raises(ValueError, match="should match the length of the metric collection"):
            pkg.MetricTracker(pkg.MeanMetric(**kw), maximize=[True])
        tracker = pkg.MetricTracker(pkg.MeanMetric(**kw))
        for method in ("update", "forward", "compute", "compute_all"):
            with pytest.raises(ValueError, match=f"`{method}` cannot be called before `.increment\\(\\)`"):
                getattr(tracker, method)(*([np.float32(1.0)] if method in ("update", "forward") else []))


@pytest.mark.parametrize("fused", [False, True])
def test_tracker_steps_share_no_engine_or_state_with_their_source(fused):
    """``increment`` deep-copies the base: a step holds no engine of the
    base or of another step, and none of their state tensors."""
    base = (M.MetricCollection([M.Accuracy(num_classes=C, jit_update=True, device="cpu"),
                                M.Precision(num_classes=C, average="macro", jit_update=True, device="cpu")],
                               fused_update=True)
            if fused else M.Accuracy(num_classes=C, average="macro", jit_update=True, device="cpu"))
    p, t = _cls_batches(50, n=1)[0]
    base.update(_t(p), _t(t))
    tracker = M.MetricTracker(base)
    tracker.increment()
    tracker.update(_t(p), _t(t))
    tracker.increment()
    members = (lambda m: list(m.values(copy_state=False))) if fused else (lambda m: [m])
    for step in tracker._steps:
        for a, b in zip(members(step), members(base)):
            assert a._dispatcher is None or a._dispatcher is not b._dispatcher
            for k in a._defaults:
                assert getattr(a, k).untyped_storage().data_ptr() != getattr(b, k).untyped_storage().data_ptr()
    assert tracker[1].compute() is not None
    _close(tracker[0].compute(), base.compute())


# -------------------------------------------------------------- checkpoints
def _wrapped(pkg, kind, **kw):
    if kind == "bootstrap":
        return pkg.BootStrapper(pkg.Accuracy(num_classes=C, average="macro", **kw), num_bootstraps=3)
    if kind == "multioutput":
        return pkg.MultioutputWrapper(pkg.MeanSquaredError(**kw), 2)
    if kind == "classwise":
        return pkg.ClasswiseWrapper(pkg.Accuracy(num_classes=C, average="none", **kw))
    return pkg.MinMaxMetric(pkg.MeanMetric(**kw))


def _feed(m, pkg, kind, seed):
    conv = jnp.asarray if pkg is J else _t
    if kind in ("bootstrap", "classwise"):
        for p, t in _cls_batches(seed, n=2):
            m.update(conv(p), conv(t))
    elif kind == "multioutput":
        for p, t in _reg_batches(seed, n=2, outputs=2):
            m.update(conv(p), conv(t))
    else:
        for p, _ in _reg_batches(seed, n=2):
            m.update(conv(p))


def _persist(m):
    for _, child in m._children():
        child.persistent(True)


@pytest.mark.parametrize("kind", ["bootstrap", "multioutput", "classwise", "minmax"])
def test_wrapper_checkpoints_cross_between_packages(kind):
    """The nested payloads (``metrics.<i>.<state>``, ``metric.<state>``,
    ``_base_metric.<state>``) load in the other package bit for bit, both ways."""
    jm = _wrapped(J, kind)
    if kind == "bootstrap":
        jm._rng = np.random.RandomState(2)
    _feed(jm, J, kind, 60)
    _persist(jm)
    payload = jm.state_dict()
    assert any("." in k for k in payload)
    tm = _wrapped(M, kind, device="cpu")
    load_jax_state_dict(tm, payload)
    _close(tm.compute(), jm.compute(), "jax -> port")
    _persist(tm)
    _feed(tm, M, kind, 61)
    back = _wrapped(J, kind)
    back.load_state_dict(to_jax_state_dict(tm))
    if kind == "bootstrap":
        for a, b in zip(back.metrics, tm.metrics):
            _states_equal(a, b, exact_floats=True)
    elif kind == "minmax":  # min_val and max_val are no states: the tracked extremes stay behind
        _close(tm.compute()["raw"], back.compute()["raw"], "port -> jax")
    else:
        _close(tm.compute(), back.compute(), "port -> jax")
