"""The port's fast dispatch (``jit_update=True``), fused collection update and
``scan_update`` held against the JAX package on the CPU.

The counterpart of ``tests/bases/test_fast_dispatch.py`` and
``tests/bases/test_fused_collection.py``. The same seeded numpy inputs go
through both packages with the engine on. On the CPU the port's engine runs
its program directly (padding, mask and traced flag as on the card, no
graph), so these tests pin its semantics: the state must equal the JAX
package's bit for bit (integer counts and float sums of the same order:
exact), float values to ``rtol=1e-6`` (float32 in both, computed in another
order), and ``dispatch_stats`` must count the JAX dispatcher's
``dispatches``, ``retraces`` and ``evictions``: one program a shape bucket,
none more within one, tiny batches sharing ``MIN_BUCKET``, exact-shape
programs for a metric without a masked update.
"""
import copy
import pickle
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu_torch
from metrics_tpu.dispatch import MIN_BUCKET as JAX_MIN_BUCKET
from metrics_tpu.metric import Metric as JaxMetric
from metrics_tpu_torch import Metric, MetricCollection
from metrics_tpu_torch.dispatch import MIN_BUCKET
from metrics_tpu_torch.utilities.checks import _is_traced, tracing
from metrics_tpu_torch.utilities.data import pad_axis0
from metrics_tpu_torch.utilities.exceptions import MetricsUserError

RTOL = 1e-6
C = 7
SIZES = (3, 5, 8, 9, 16, 17, 100)


def _pair(rng, b, c=C, ints=False):
    """One batch as (jax, torch) pairs of (scores or int labels, int labels)."""
    preds = rng.randint(0, c, b).astype(np.int32) if ints else rng.rand(b, c).astype(np.float32)
    target = rng.randint(0, c, b).astype(np.int32)
    return (jnp.asarray(preds), jnp.asarray(target)), (torch.from_numpy(preds), torch.from_numpy(target))


def _assert_state_equal(jm, tm):
    for name in tm._defaults:
        a, b = np.asarray(getattr(jm, name)), getattr(tm, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name


def _counts(stats):
    return {k: stats.get(k, 0) for k in ("dispatches", "retraces", "evictions")}


def _both(name, **kwargs):
    return getattr(metrics_tpu, name)(jit_update=True, **kwargs), getattr(metrics_tpu_torch, name)(
        jit_update=True, device="cpu", **kwargs
    )


class _JaxFloatSum(JaxMetric):
    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", jnp.asarray(0.0), dist_reduce_fx="sum")

    def update(self, values, scale=1.0, negate=False):
        self.total = self.total + (-1.0 if negate else 1.0) * scale * jnp.sum(values)

    def compute(self):
        return self.total


class _FloatSum(Metric):
    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, values, scale=1.0, negate=False):
        self.total = self.total + (-1.0 if negate else 1.0) * scale * torch.sum(torch.as_tensor(values))

    def compute(self):
        return self.total


# -------------------------------------------------------------- the metrics
@pytest.mark.parametrize("average", ["micro", "macro"])
def test_accuracy_state_and_counts_equal_jax_across_batch_sizes(average):
    rng = np.random.RandomState(0)
    jm, tm = _both("Accuracy", num_classes=C, average=average)
    for b in SIZES:
        (jp, jt), (tp, tt) = _pair(rng, b)
        jm.update(jp, jt)
        tm.update(tp, tt)
        _assert_state_equal(jm, tm)
    assert _counts(tm.dispatch_stats) == _counts(jm.dispatch_stats) == {"dispatches": 7, "retraces": 4, "evictions": 0}
    np.testing.assert_allclose(tm.compute().numpy(), np.asarray(jm.compute()), rtol=RTOL)
    assert tm.dispatch_stats["demotions"] == 0


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("StatScores", dict(num_classes=C, reduce="macro")),
        ("Precision", dict(num_classes=C, average="macro")),
        ("Recall", dict(num_classes=C, average="weighted")),
        ("F1Score", dict(num_classes=C, average="micro")),
        ("FBetaScore", dict(num_classes=C, beta=0.5, average="macro")),
        ("Specificity", dict(num_classes=C, average="macro")),
        ("HammingDistance", {}),
        ("ConfusionMatrix", dict(num_classes=C)),
        ("CohenKappa", dict(num_classes=C, weights="quadratic")),
        ("MatthewsCorrCoef", dict(num_classes=C)),
        ("JaccardIndex", dict(num_classes=C)),
    ],
)
def test_family_state_and_counts_equal_jax(name, kwargs):
    rng = np.random.RandomState(1)
    jm, tm = _both(name, **kwargs)
    for b in SIZES:
        (jp, jt), (tp, tt) = _pair(rng, b)
        jm.update(jp, jt)
        tm.update(tp, tt)
    _assert_state_equal(jm, tm)
    np.testing.assert_allclose(tm.compute().numpy(), np.asarray(jm.compute()), rtol=RTOL, atol=2.0**-23)
    # the stat-scores family masks (4 buckets); the rest gets a program a shape (7)
    assert _counts(tm.dispatch_stats) == _counts(jm.dispatch_stats)


def test_confusion_matrix_matmul_gets_exact_shape_programs():
    rng = np.random.RandomState(2)
    jm = metrics_tpu.ConfusionMatrix(num_classes=C, jit_update=True)
    tm = metrics_tpu_torch.ConfusionMatrix(num_classes=C, update_method="matmul", jit_update=True, device="cpu")
    for b in (16, 9, 16, 9, 3):
        (jp, jt), (tp, tt) = _pair(rng, b)
        jm.update(jp, jt)
        tm.update(tp, tt)
    _assert_state_equal(jm, tm)
    assert _counts(tm.dispatch_stats) == _counts(jm.dispatch_stats) == {"dispatches": 5, "retraces": 3, "evictions": 0}


def test_zero_retraces_within_a_bucket_and_a_new_one_past_it():
    rng = np.random.RandomState(3)
    jm, tm = _both("Accuracy", num_classes=C, average="macro")
    for b in (100, 120, 127, 128, 129, 200):
        (jp, jt), (tp, tt) = _pair(rng, b)
        jm.update(jp, jt)
        tm.update(tp, tt)
    assert _counts(tm.dispatch_stats) == _counts(jm.dispatch_stats) == {"dispatches": 6, "retraces": 2, "evictions": 0}
    assert tm._dispatcher.causes == {("update", "first-compile"): 1, ("update", "new-shape-bucket"): 1}


def test_tiny_batches_share_min_bucket():
    assert MIN_BUCKET == JAX_MIN_BUCKET == 8
    rng = np.random.RandomState(4)
    jm, tm = _both("Accuracy", num_classes=C, average="macro")
    for b in range(2, MIN_BUCKET + 1):
        (jp, jt), (tp, tt) = _pair(rng, b)
        jm.update(jp, jt)
        tm.update(tp, tt)
    assert tm.dispatch_stats["retraces"] == jm.dispatch_stats["retraces"] == 1
    _assert_state_equal(jm, tm)


def test_padded_rows_are_exact_noops():
    rng = np.random.RandomState(5)
    (_, _), (tp, tt) = _pair(rng, 100)
    padded = metrics_tpu_torch.Accuracy(num_classes=C, average="macro", jit_update=True, device="cpu")
    padded.update(*_pair(rng, 128)[1])  # builds the 128-row program
    padded.reset()
    padded.update(tp, tt)  # 100 rows and 28 padded ones through it
    assert padded.dispatch_stats["retraces"] == 1
    exact = metrics_tpu_torch.Accuracy(num_classes=C, average="macro", device="cpu")
    exact.update(tp, tt)
    for name in exact._defaults:
        assert torch.equal(getattr(padded, name), getattr(exact, name))
    # the rows a mask drops add nothing even where they hold a valid label of every class
    m = metrics_tpu_torch.Accuracy(num_classes=C, average="macro", device="cpu")
    junk = torch.nn.functional.one_hot(torch.arange(28) % C, C).float()
    state = m._masked_pure_update(m.default_state(), torch.arange(128) < 100, torch.cat([tp, junk]),
                                  torch.cat([tt, torch.arange(28, dtype=torch.int32) % C]))
    for name in exact._defaults:
        assert torch.equal(state[name], getattr(exact, name))


def test_pad_axis0_matches_jax():
    from metrics_tpu.utilities.data import pad_axis0 as jax_pad

    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    assert np.array_equal(pad_axis0(torch.from_numpy(x), 8).numpy(), np.asarray(jax_pad(jnp.asarray(x), 8)))
    assert pad_axis0(torch.tensor(3.0), 8).shape == ()
    assert pad_axis0(torch.zeros(9), 8).shape == (9,)


@pytest.mark.parametrize("name", ["Accuracy", "ConfusionMatrix", "CohenKappa", "Precision"])
def test_out_of_range_labels_count_as_the_jax_engine_counts_them(name):
    """The engine skips the value checks, as ``jax.jit`` does: labels past
    ``num_classes`` and negative ones are counted the JAX package's way, not refused."""
    rng = np.random.RandomState(6)
    kwargs = dict(num_classes=C) if name in ("ConfusionMatrix", "CohenKappa") else dict(num_classes=C, average="macro")
    jm, tm = _both(name, **kwargs)
    for b in (16, 12):
        preds = rng.rand(b, C).astype(np.float32)
        target = rng.randint(-2, C + 3, b).astype(np.int32)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_state_equal(jm, tm)
    eager = getattr(metrics_tpu_torch, name)(device="cpu", **kwargs)
    with pytest.raises(ValueError):
        eager.update(torch.from_numpy(preds), torch.from_numpy(target))


def test_integer_labels_without_num_classes_raise_under_the_engine():
    rng = np.random.RandomState(7)
    (jp, jt), (tp, tt) = _pair(rng, 16, ints=True)
    jm, tm = _both("StatScores", reduce="micro")
    with pytest.raises(ValueError) as jax_err:
        jm.update(jp, jt)
    with pytest.raises(ValueError) as torch_err:
        tm.update(tp, tt)
    assert str(torch_err.value) == str(jax_err.value)
    with tracing():
        assert _is_traced()
    assert not _is_traced()
    eager = metrics_tpu_torch.StatScores(reduce="micro", device="cpu")
    eager.update(tp, tt)  # the eager path infers the class count


@pytest.mark.parametrize("name,kwargs", [("QuantileSketch", dict(bins=64)), ("HyperLogLog", dict(precision=6)),
                                         ("CountMinHeavyHitters", dict(depth=3, width=64))])
def test_sketch_masked_updates_equal_jax(name, kwargs):
    rng = np.random.RandomState(8)
    jm, tm = _both(name, **kwargs)
    for b in SIZES:
        x = (rng.randn(b) * 10).round().astype(np.float32)
        x[::4] = np.nan
        jm.update(jnp.asarray(x))
        tm.update(torch.from_numpy(x))
    _assert_state_equal(jm, tm)
    assert tm._masked_update_supported()
    assert _counts(tm.dispatch_stats) == _counts(jm.dispatch_stats) == {"dispatches": 7, "retraces": 4, "evictions": 0}


def test_count_min_weight_kwarg_is_an_input_not_a_key():
    rng = np.random.RandomState(9)
    jm, tm = _both("CountMinHeavyHitters", depth=2, width=32)
    for b, w in ((10, 1.0), (12, 2.5), (9, 4.0)):
        x = rng.randint(0, 50, b).astype(np.float32)
        jm.update(jnp.asarray(x), weight=w)
        tm.update(torch.from_numpy(x), weight=w)
    _assert_state_equal(jm, tm)
    assert _counts(tm.dispatch_stats) == _counts(jm.dispatch_stats)


def test_static_flags_key_programs_and_numbers_stay_inputs():
    rng = np.random.RandomState(10)
    jm, tm = _JaxFloatSum(jit_update=True), _FloatSum(jit_update=True)
    for negate, scale in ((False, 1.0), (True, 2.0), (False, 3.0), (True, 0.5)):
        x = rng.rand(6).astype(np.float32)
        jm.update(jnp.asarray(x), scale=scale, negate=negate)
        tm.update(torch.from_numpy(x), scale, negate)  # a positional flag is found as well
    _assert_state_equal(jm, tm)
    assert _counts(tm.dispatch_stats) == _counts(jm.dispatch_stats) == {"dispatches": 4, "retraces": 2, "evictions": 0}
    assert tm._dispatcher.causes == {("update", "first-compile"): 1, ("update", "new-static-key"): 1}


def test_cache_is_bounded_and_counts_evictions(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_CACHE_MAX", "2")
    rng = np.random.RandomState(11)
    jm, tm = _both("Accuracy", num_classes=C, average="macro")
    for b in (8, 16, 32, 8, 64):
        (jp, jt), (tp, tt) = _pair(rng, b)
        jm.update(jp, jt)
        tm.update(tp, tt)
    _assert_state_equal(jm, tm)
    assert _counts(tm.dispatch_stats) == _counts(jm.dispatch_stats) == {"dispatches": 5, "retraces": 5, "evictions": 3}


def test_kill_switch_takes_the_eager_path(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_FAST_DISPATCH", "0")
    rng = np.random.RandomState(12)
    tm = metrics_tpu_torch.Accuracy(num_classes=C, average="macro", jit_update=True, device="cpu")
    ref = metrics_tpu_torch.Accuracy(num_classes=C, average="macro", device="cpu")
    for b in (64, 64, 48):
        _, (tp, tt) = _pair(rng, b)
        tm.update(tp, tt)
        ref.update(tp, tt)
    assert tm._dispatcher is None and tm.dispatch_stats["dispatches"] == 3 and tm.dispatch_stats["retraces"] == 0
    for name in ref._defaults:
        assert torch.equal(getattr(tm, name), getattr(ref, name))


def test_list_state_metrics_take_the_eager_path():
    tm = metrics_tpu_torch.CatMetric(jit_update=True, device="cpu")
    tm.update(torch.tensor([1.0, 2.0]))
    tm.update(torch.tensor([3.0]))
    assert tm._dispatcher is None and tm.dispatch_stats["dispatches"] == 2
    assert torch.equal(tm.compute(), torch.tensor([1.0, 2.0, 3.0]))


def test_unsupported_inputs_degrade_for_good_and_stay_right():
    tm = _FloatSum(jit_update=True)
    tm.update(torch.tensor([1.0, 2.0]), scale=Fraction(1))  # no tensor, number or flag: the eager path serves it
    assert tm.dispatch_stats["permanent"] and tm.dispatch_stats["last_cause"] == "unsupported"
    tm.update(torch.tensor([3.0]))
    assert float(tm.compute()) == 6.0 and tm._dispatcher is None


def test_engine_metric_survives_pickle_clone_and_reset():
    rng = np.random.RandomState(13)
    _, (tp, tt) = _pair(rng, 40)
    m = metrics_tpu_torch.Accuracy(num_classes=C, average="macro", jit_update=True, device="cpu")
    m.update(tp, tt)
    clone = m.clone()
    clone.update(tp, tt)
    revived = pickle.loads(pickle.dumps(m))
    assert revived._dispatcher is None
    revived.update(tp, tt)  # builds its programs again
    m.reset()
    m.update(tp, tt)
    m.update(tp, tt)
    for name in m._defaults:
        assert torch.equal(getattr(m, name), getattr(revived, name))
        assert torch.equal(getattr(m, name), getattr(clone, name))
    assert copy.deepcopy(m).dispatch_stats["dispatches"] == 3


def test_state_taken_before_an_engine_update_keeps_its_values():
    rng = np.random.RandomState(14)
    m = metrics_tpu_torch.Accuracy(num_classes=C, average="macro", jit_update=True, device="cpu")
    m.update(*_pair(rng, 16)[1])
    before = m.state()
    saved = {k: v.clone() for k, v in before.items()}
    payload = m.state_dict()
    m.update(*_pair(rng, 16)[1])
    for k in saved:
        assert torch.equal(before[k], saved[k])
    assert all(not torch.equal(getattr(m, k), saved[k]) for k in ("tp",))
    m.persistent(True)
    assert torch.equal(payload.get("tp", saved["tp"]), saved["tp"])


@pytest.mark.parametrize("kind", ["confmat", "sum", "view"])
def test_compute_value_sharing_an_engine_buffer_is_a_copy(kind):
    """On the card a replay writes the engine's state buffers in place; a
    ``compute`` value that is such a buffer, or a view of one, is copied. On
    the CPU there is no graph, so the buffer is marked as the engine marks it."""
    from metrics_tpu_torch import dispatch

    rng = np.random.RandomState(15)
    if kind == "confmat":
        m, leaf = metrics_tpu_torch.ConfusionMatrix(C, update_method="matmul", jit_update=True, device="cpu"), "confmat"
        m.update(*_pair(rng, 16)[1])
    else:
        m, leaf = metrics_tpu_torch.SumMetric(jit_update=True, device="cpu"), "value"
        m.update(torch.from_numpy(rng.rand(16).astype(np.float32)))
        if kind == "view":
            object.__setattr__(m, "value", m.value.reshape(1))  # compute squeezes it: a view of the leaf
    buf = getattr(m, leaf)
    want = m._compute_impl().clone()
    dispatch._OWNED[id(buf)] = buf
    try:
        got = m.compute()
        assert got is not buf and got.untyped_storage().data_ptr() != buf.untyped_storage().data_ptr()
        buf.add_(1)  # what a later replay does
        assert torch.equal(got, want.reshape(got.shape))
    finally:
        dispatch._OWNED.pop(id(buf), None)
    m.reset()
    m.update(*(_pair(rng, 16)[1] if kind == "confmat" else (torch.ones(4),)))
    assert m.compute() is m.compute()  # not owned: held as it is, and memoised


# --------------------------------------------------------------- scan_update
def test_scan_update_equals_jax_lax_scan_fold():
    rng = np.random.RandomState(15)
    P = rng.rand(5, 16, C).astype(np.float32)
    T = rng.randint(0, C, (5, 16)).astype(np.int32)
    jm = metrics_tpu.Accuracy(num_classes=C, average="macro")
    tm = metrics_tpu_torch.Accuracy(num_classes=C, average="macro", device="cpu")
    js = jm.scan_update(jm.default_state(), jnp.asarray(P), jnp.asarray(T))
    ts = tm.scan_update(tm.default_state(), torch.from_numpy(P), torch.from_numpy(T))
    for k in ts:
        assert np.array_equal(np.asarray(js[k]), ts[k].numpy()), k
    assert all(int(getattr(tm, k).sum()) == 0 for k in tm._defaults)  # pure: the metric's state as it was
    # a static flag rides along unscanned
    js2 = _JaxFloatSum().scan_update({"total": jnp.asarray(0.0)}, jnp.asarray(P[:, :, 0]), negate=True)
    ts2 = _FloatSum().scan_update({"total": torch.tensor(0.0)}, torch.from_numpy(P[:, :, 0]), negate=True)
    np.testing.assert_allclose(ts2["total"].numpy(), np.asarray(js2["total"]), rtol=RTOL)


def test_scan_update_refuses_list_states_and_no_batched_argument():
    with pytest.raises(MetricsUserError, match="fixed-shape states"):
        metrics_tpu_torch.CatMetric(device="cpu").scan_update({"value": []}, torch.zeros(2, 3))
    with pytest.raises(MetricsUserError, match="at least one batched argument"):
        _FloatSum().scan_update({"total": torch.tensor(0.0)}, negate=True)


def _members(pkg, **kw):
    macro = dict(num_classes=C, average="macro", **kw)
    mm = dict(update_method="matmul", **kw) if pkg is metrics_tpu_torch else {}
    return [pkg.Accuracy(**macro), pkg.Precision(**macro), pkg.Recall(**macro), pkg.F1Score(**macro),
            pkg.FBetaScore(beta=0.5, **macro), pkg.Specificity(**macro), pkg.HammingDistance(**kw),
            pkg.ConfusionMatrix(C, **mm), pkg.CohenKappa(C, weights="quadratic", **mm),
            pkg.MatthewsCorrCoef(C, **mm), pkg.JaccardIndex(C, **mm)]


def test_collection_scan_update_equals_jax():
    rng = np.random.RandomState(16)
    P = rng.rand(4, 12, C).astype(np.float32)
    T = rng.randint(0, C, (4, 12)).astype(np.int32)
    jc = metrics_tpu.MetricCollection(_members(metrics_tpu))
    tc = MetricCollection(_members(metrics_tpu_torch, device="cpu"))
    js = jc.scan_update(jc.state(), jnp.asarray(P), jnp.asarray(T))
    ts = tc.scan_update(tc.state(), torch.from_numpy(P), torch.from_numpy(T))
    for name in ts:
        for k in ts[name]:
            assert np.array_equal(np.asarray(js[name][k]), ts[name][k].numpy()), (name, k)


# ------------------------------------------------------- the fused collection
def test_fused_collection_update_equals_jax_fused_and_eager():
    rng = np.random.RandomState(17)
    jc = metrics_tpu.MetricCollection(_members(metrics_tpu), prefix="val_", fused_update=True)
    tc = MetricCollection(_members(metrics_tpu_torch, device="cpu"), prefix="val_", fused_update=True)
    eager = MetricCollection(_members(metrics_tpu_torch, device="cpu"), prefix="val_", compute_groups=False)
    for b in SIZES:
        (jp, jt), (tp, tt) = _pair(rng, b)
        jc.update(jp, jt)
        tc.update(tp, tt)
        eager.update(tp, tt)
    for name, m in tc.items(keep_base=True):
        _assert_state_equal(jc[name], m)
        for k in m._defaults:
            assert torch.equal(getattr(m, k), getattr(eager[name], k))
    jv, tv, ev = jc.compute(), tc.compute(), eager.compute()
    for k in jv:
        np.testing.assert_allclose(tv[k].numpy(), np.asarray(jv[k]), rtol=RTOL, atol=2.0**-23)
        assert torch.equal(tv[k], ev[k])
    # members without a masked update: a program a shape, as in the JAX package
    assert _counts(tc.dispatch_stats) == _counts(jc.dispatch_stats) == {"dispatches": 7, "retraces": 7, "evictions": 0}
    assert tc.compute_groups == {i: [k] for i, k in enumerate(tc.keys(keep_base=True))}  # groups not consulted


def test_fused_collection_masks_when_every_member_masks():
    rng = np.random.RandomState(18)

    def members(pkg, **kw):
        return {"acc": pkg.Accuracy(num_classes=C, average="macro", **kw),
                "prec": pkg.Precision(num_classes=C, average="macro", **kw),
                "rec": pkg.Recall(num_classes=C, average="micro", **kw)}

    jc = metrics_tpu.MetricCollection(members(metrics_tpu), fused_update=True)
    tc = MetricCollection(members(metrics_tpu_torch, device="cpu"), fused_update=True)
    for b in SIZES:
        (jp, jt), (tp, tt) = _pair(rng, b)
        jc.update(jp, jt)
        tc.update(tp, tt)
    for name in tc:
        _assert_state_equal(jc[name], tc[name])
    assert _counts(tc.dispatch_stats) == _counts(jc.dispatch_stats) == {"dispatches": 7, "retraces": 4, "evictions": 0}


def test_fused_collection_falls_back_for_good_on_list_state_members():
    tc = MetricCollection([metrics_tpu_torch.CatMetric(device="cpu"), metrics_tpu_torch.SumMetric(device="cpu")],
                          fused_update=True)
    with pytest.warns(UserWarning, match="could not fuse"):
        tc.update(torch.tensor([1.0, 2.0]))
    tc.update(torch.tensor([3.0]))
    assert tc._fuse_failed and tc._dispatcher is None
    assert float(tc.compute()["SumMetric"]) == 6.0


def test_fused_collection_survives_pickle_reset_and_reuse():
    rng = np.random.RandomState(19)
    batches = [_pair(rng, b)[1] for b in (12, 9)]
    tc = MetricCollection(_members(metrics_tpu_torch, device="cpu"), fused_update=True)
    for b in batches:
        tc.update(*b)
    first = tc.compute()
    revived = pickle.loads(pickle.dumps(tc))
    assert revived._dispatcher is None
    tc.reset()
    for b in batches:
        tc.update(*b)
    for k, v in tc.compute().items():
        assert torch.equal(v, first[k])
        assert torch.equal(revived.compute()[k], first[k])


def test_fused_update_resolves_none_by_device():
    tc = MetricCollection([_FloatSum()])
    assert tc._fused_update is None and not tc._fusion_enabled  # eager on the CPU
    assert MetricCollection([_FloatSum()], fused_update=True)._fusion_enabled
