"""The port's curve metrics (AUC, ROC, AUROC) and ``compute_on_cpu`` held
against the JAX package on the CPU.

The same seeded numpy inputs go through ``metrics_tpu`` and
``metrics_tpu_torch``. Tolerances:

* bit-equal: the ROC curve's counts and thresholds (``_binary_clf_curve``'s
  ``fps``, ``tps`` and scores, unweighted), and the false and true positive
  rates too: they are one float32 division of equal counts, so they come out
  bit-equal, and are held so;
* rtol 1e-6: the counts of a weighted curve (float32 cumulative sums);
* rtol 1e-5: AUC and AUROC, whose trapezoid sums float32 terms in another
  order than XLA.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu.functional as jF
import metrics_tpu_torch
import metrics_tpu_torch.functional as tF
from metrics_tpu.functional.classification.precision_recall_curve import _binary_clf_curve as jax_clf_curve
from metrics_tpu_torch.functional.classification.precision_recall_curve import _binary_clf_curve
from metrics_tpu_torch.interop import load_jax_state_dict, to_jax_state_dict

AREA_RTOL = 1e-5
COUNT_RTOL = 1e-6


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert(ref, got, rtol=None):
    """``ref`` (JAX) against ``got`` (port): arrays, or lists/tuples of them;
    bit-equal (NaN where NaN) unless ``rtol`` is given."""
    if isinstance(ref, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(ref)
        for r, g in zip(ref, got):
            _assert(r, g, rtol)
        return
    ref, got = np.asarray(ref), got.numpy()
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if rtol is None:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)


def _same_error(jax_call, torch_call):
    with pytest.raises(Exception) as jax_err:
        jax_call()
    with pytest.raises(Exception) as torch_err:
        torch_call()
    assert type(torch_err.value) is type(jax_err.value)
    assert str(torch_err.value) == str(jax_err.value)


def _scores(rng, shape, kind):
    """Float32 scores: uniform, on a 1/8 grid (ties), or with NaN and +-0 among ties."""
    preds = rng.rand(*shape).astype(np.float32)
    if kind in ("ties", "nan and signed zeros"):
        preds = (np.round(preds * 8) / 8).astype(np.float32)
    if kind == "nan and signed zeros":
        flat = preds.reshape(-1)
        pick = rng.rand(flat.size)
        flat[pick < 0.05] = np.nan
        flat[(pick >= 0.05) & (pick < 0.15)] = -0.0
        flat[(pick >= 0.15) & (pick < 0.25)] = 0.0
    return preds


# ------------------------------------------------------------------- AUC
@pytest.mark.parametrize("kind", ["increasing", "decreasing", "reorder", "integers", "column vectors"])
def test_auc_functional_equal_to_jax(kind):
    rng = np.random.RandomState(1)
    x = np.sort(rng.rand(257)).astype(np.float32)
    y = rng.rand(257).astype(np.float32)
    reorder = False
    if kind == "decreasing":
        x = x[::-1].copy()
    elif kind == "reorder":
        perm = rng.permutation(x.size)
        x, y, reorder = x[perm], y[perm], True
    elif kind == "integers":
        x, y = np.arange(20), rng.randint(0, 9, 20)
    elif kind == "column vectors":
        x, y = x[:, None], y[:, None]
    _assert(jF.auc(jnp.asarray(x), jnp.asarray(y), reorder=reorder), tF.auc(_t(x), _t(y), reorder=reorder), AREA_RTOL)


@pytest.mark.parametrize("case", ["neither increasing nor decreasing", "2-d", "lengths differ"])
def test_auc_errors_like_jax(case):
    x, y = np.array([0.0, 2.0, 1.0], np.float32), np.array([1.0, 2.0, 3.0], np.float32)
    if case == "2-d":
        x, y = np.ones((2, 3), np.float32), np.ones((2, 3), np.float32)
    elif case == "lengths differ":
        y = np.ones(4, np.float32)
    _same_error(lambda: jF.auc(jnp.asarray(x), jnp.asarray(y)), lambda: tF.auc(_t(x), _t(y)))


@pytest.mark.parametrize("reorder", [False, True])
def test_auc_module_over_batches_equal_to_jax(reorder):
    rng = np.random.RandomState(2)
    x = np.sort(rng.rand(90)).astype(np.float32)
    y = rng.rand(90).astype(np.float32)
    if reorder:
        perm = rng.permutation(90)
        x, y = x[perm], y[perm]
    jm, tm = metrics_tpu.AUC(reorder=reorder), metrics_tpu_torch.AUC(reorder=reorder, device="cpu")
    for sl in (slice(0, 30), slice(30, 31), slice(31, 90)):
        jm.update(jnp.asarray(x[sl]), jnp.asarray(y[sl]))
        tm.update(_t(x[sl]), _t(y[sl]))
    _assert(jm.compute(), tm.compute(), AREA_RTOL)


# ------------------------------------------------------------------- ROC
@pytest.mark.parametrize("kind", ["uniform", "ties", "nan and signed zeros", "weights"])
@pytest.mark.parametrize("pos_label", [1, 2])
def test_binary_clf_curve_counts_bit_equal_to_jax(kind, pos_label):
    rng = np.random.RandomState(3 + pos_label)
    preds = _scores(rng, (300,), "ties" if kind == "weights" else kind)
    target = rng.randint(0, 3, 300)
    weights = rng.rand(300).astype(np.float32) if kind == "weights" else None
    ref = jax_clf_curve(jnp.asarray(preds), jnp.asarray(target), None if weights is None else jnp.asarray(weights),
                        pos_label=pos_label)
    got = _binary_clf_curve(_t(preds), _t(target), None if weights is None else _t(weights), pos_label=pos_label)
    # weighted counts are float32 cumulative sums, in another order; the scores stay bit-equal
    _assert(ref[:2], got[:2], COUNT_RTOL if weights is not None else None)
    _assert(ref[2], got[2])


@pytest.mark.parametrize("kind", ["uniform", "ties", "nan and signed zeros"])
def test_binary_roc_bit_equal_to_jax(kind):
    rng = np.random.RandomState(5)
    preds = _scores(rng, (250,), kind)
    target = rng.randint(0, 2, 250)
    _assert(jF.roc(jnp.asarray(preds), jnp.asarray(target), pos_label=1), tF.roc(_t(preds), _t(target), pos_label=1))


@pytest.mark.parametrize("mode", ["multiclass", "multilabel", "multidim multilabel"])
@pytest.mark.parametrize("kind", ["uniform", "ties"])
def test_roc_per_class_bit_equal_to_jax(mode, kind):
    rng = np.random.RandomState(6)
    c = 5
    if mode == "multiclass":
        preds, target = _scores(rng, (200, c), kind), rng.randint(0, c, 200)
    elif mode == "multilabel":
        preds, target = _scores(rng, (200, c), kind), rng.randint(0, 2, (200, c))
    else:
        preds, target = _scores(rng, (40, c, 3), kind), rng.randint(0, 2, (40, c, 3))
    ref = jF.roc(jnp.asarray(preds), jnp.asarray(target), num_classes=c)
    got = tF.roc(_t(preds), _t(target), num_classes=c)
    _assert(ref, got)


def test_roc_sample_weights_equal_to_jax():
    rng = np.random.RandomState(7)
    preds, target = _scores(rng, (200,), "ties"), rng.randint(0, 2, 200)
    w = rng.rand(200).astype(np.float32)
    ref = jF.roc(jnp.asarray(preds), jnp.asarray(target), pos_label=1, sample_weights=jnp.asarray(w))
    got = tF.roc(_t(preds), _t(target), pos_label=1, sample_weights=_t(w))
    _assert(ref[:2], got[:2], COUNT_RTOL)
    _assert(ref[2], got[2])
    # a list of weights becomes a float32 tensor in both packages
    got_list = tF.roc(_t(preds), _t(target), pos_label=1, sample_weights=w.tolist())
    _assert(ref[:2], got_list[:2], COUNT_RTOL)


@pytest.mark.parametrize("missing", ["negatives", "positives"])
def test_roc_warns_and_returns_zeros_like_jax(missing):
    preds = np.array([0.1, 0.4, 0.35, 0.8], np.float32)
    target = np.ones(4, np.int64) if missing == "negatives" else np.zeros(4, np.int64)
    match = "No negative samples" if missing == "negatives" else "No positive samples"
    with pytest.warns(UserWarning, match=match):
        ref = jF.roc(jnp.asarray(preds), jnp.asarray(target), pos_label=1)
    with pytest.warns(UserWarning, match=match):
        got = tF.roc(_t(preds), _t(target), pos_label=1)
    _assert(ref, got)


@pytest.mark.parametrize("mode", ["binary", "multiclass"])
def test_roc_module_over_batches_bit_equal_to_jax(mode):
    rng = np.random.RandomState(8)
    kwargs = dict(pos_label=1) if mode == "binary" else dict(num_classes=4)
    jm, tm = metrics_tpu.ROC(**kwargs), metrics_tpu_torch.ROC(device="cpu", **kwargs)
    for n in (30, 1, 50):
        preds = _scores(rng, (n,) if mode == "binary" else (n, 4), "ties")
        target = rng.randint(0, 2 if mode == "binary" else 4, n)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(_t(preds), _t(target))
    _assert(jm.compute(), tm.compute())
    _same_error(lambda: metrics_tpu.ROC().compute(), lambda: metrics_tpu_torch.ROC(device="cpu").compute())


# ----------------------------------------------------------------- AUROC
def _auroc_inputs(mode, kind="uniform", seed=9, n=240, c=5):
    rng = np.random.RandomState(seed)
    if mode == "binary":
        return _scores(rng, (n,), kind), rng.randint(0, 2, n)
    if mode == "multiclass":
        logits = _scores(rng, (n, c), kind)
        return logits, rng.randint(0, c, n)
    if mode == "multilabel":
        return _scores(rng, (n, c), kind), rng.randint(0, 2, (n, c))
    if mode == "multidim multiclass":
        return _scores(rng, (n // 8, c, 8), kind), rng.randint(0, c, (n // 8, 8))
    return _scores(rng, (n // 8, c, 8), kind), rng.randint(0, 2, (n // 8, c, 8))  # multidim multilabel


@pytest.mark.parametrize(
    "mode,average",
    [("binary", None), ("binary", "macro")]
    + [(m, a) for m in ("multiclass", "multidim multiclass") for a in ("macro", "weighted", "none")]
    + [(m, a) for m in ("multilabel", "multidim multilabel") for a in ("micro", "macro", "weighted", "none")],
)
@pytest.mark.parametrize("kind", ["uniform", "ties"])
def test_auroc_functional_equal_to_jax(mode, average, kind):
    preds, target = _auroc_inputs(mode, kind)
    kwargs = dict(pos_label=1) if mode == "binary" else dict(num_classes=5)
    ref = jF.auroc(jnp.asarray(preds), jnp.asarray(target), average=average, **kwargs)
    got = tF.auroc(_t(preds), _t(target), average=average, **kwargs)
    _assert(ref, got, AREA_RTOL)


@pytest.mark.parametrize("kind", ["ties", "nan and signed zeros"])
@pytest.mark.parametrize("max_fpr", [None, 0.01, 0.1, 0.5, 1.0])
def test_binary_auroc_and_partial_auc_equal_to_jax(kind, max_fpr):
    rng = np.random.RandomState(10)
    preds, target = _scores(rng, (300,), kind), rng.randint(0, 2, 300)
    ref = jF.auroc(jnp.asarray(preds), jnp.asarray(target), pos_label=1, max_fpr=max_fpr)
    got = tF.auroc(_t(preds), _t(target), pos_label=1, max_fpr=max_fpr)
    _assert(ref, got, AREA_RTOL)


def test_partial_auc_with_no_negative_is_nan_like_jax():
    preds, target = np.array([0.2, 0.6, 0.9], np.float32), np.ones(3, np.int64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jF.auroc(jnp.asarray(preds), jnp.asarray(target), pos_label=1, max_fpr=0.5)
        got = tF.auroc(_t(preds), _t(target), pos_label=1, max_fpr=0.5)
    assert np.isnan(np.asarray(ref)) and bool(torch.isnan(got))


@pytest.mark.parametrize("mode", ["binary", "multiclass"])
def test_auroc_sample_weights_equal_to_jax(mode):
    preds, target = _auroc_inputs(mode, "ties", seed=11)
    w = np.random.RandomState(12).rand(preds.shape[0]).astype(np.float32)
    kwargs = dict(pos_label=1) if mode == "binary" else dict(num_classes=5)
    ref = jF.auroc(jnp.asarray(preds), jnp.asarray(target), sample_weights=jnp.asarray(w), **kwargs)
    got = tF.auroc(_t(preds), _t(target), sample_weights=_t(w), **kwargs)
    _assert(ref, got, AREA_RTOL)


def test_weighted_auroc_drops_and_warns_for_a_class_with_no_observation_like_jax():
    preds, target = _auroc_inputs("multiclass", seed=13)
    target = np.where(target == 2, 4, target)  # class 2 never observed
    with pytest.warns(UserWarning, match="Class 2 had 0 observations"):
        ref = jF.auroc(jnp.asarray(preds), jnp.asarray(target), num_classes=5, average="weighted")
    with pytest.warns(UserWarning, match="Class 2 had 0 observations"):
        got = tF.auroc(_t(preds), _t(target), num_classes=5, average="weighted")
    _assert(ref, got, AREA_RTOL)
    one = np.zeros_like(target)  # only class 0: one non-empty class left
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _same_error(lambda: jF.auroc(jnp.asarray(preds), jnp.asarray(one), num_classes=5, average="weighted"),
                    lambda: tF.auroc(_t(preds), _t(one), num_classes=5, average="weighted"))


@pytest.mark.parametrize("case", ["max_fpr out of range", "max_fpr not a float", "max_fpr on multiclass",
                                  "multiclass without num_classes", "multilabel without num_classes",
                                  "unknown average", "average None on multiclass"])
def test_auroc_errors_like_jax(case):
    mode = {"max_fpr out of range": "binary", "max_fpr not a float": "binary",
            "multilabel without num_classes": "multilabel"}.get(case, "multiclass")
    preds, target = _auroc_inputs(mode, seed=14)
    kwargs = {
        "max_fpr out of range": dict(pos_label=1, max_fpr=1.5),
        "max_fpr not a float": dict(pos_label=1, max_fpr=1),
        "max_fpr on multiclass": dict(num_classes=5, max_fpr=0.5),
        "multiclass without num_classes": dict(),
        "multilabel without num_classes": dict(average="macro"),
        "unknown average": dict(num_classes=5, average="samples"),
        "average None on multiclass": dict(num_classes=5, average=None),
    }[case]
    _same_error(lambda: jF.auroc(jnp.asarray(preds), jnp.asarray(target), **kwargs),
                lambda: tF.auroc(_t(preds), _t(target), **kwargs))


@pytest.mark.parametrize("kwargs", [dict(pos_label=1), dict(pos_label=1, max_fpr=0.2), dict(num_classes=5),
                                    dict(num_classes=5, average="weighted"), dict(num_classes=5, average="none")])
def test_auroc_module_over_batches_equal_to_jax(kwargs):
    mode = "binary" if "pos_label" in kwargs else "multiclass"
    jm, tm = metrics_tpu.AUROC(**kwargs), metrics_tpu_torch.AUROC(device="cpu", **kwargs)
    for seed in (15, 16, 17):
        preds, target = _auroc_inputs(mode, "ties", seed=seed, n=80)
        _assert(jm(jnp.asarray(preds), jnp.asarray(target)), tm(_t(preds), _t(target)), AREA_RTOL)
    _assert(jm.compute(), tm.compute(), AREA_RTOL)
    assert tm.mode == jm.mode


def test_auroc_module_checks_like_jax():
    _same_error(lambda: metrics_tpu.AUROC(average="samples"), lambda: metrics_tpu_torch.AUROC(average="samples", device="cpu"))
    _same_error(lambda: metrics_tpu.AUROC(max_fpr=2.0), lambda: metrics_tpu_torch.AUROC(max_fpr=2.0, device="cpu"))
    _same_error(lambda: metrics_tpu.AUROC()._compute_impl(), lambda: metrics_tpu_torch.AUROC(device="cpu")._compute_impl())
    jm, tm = metrics_tpu.AUROC(num_classes=5), metrics_tpu_torch.AUROC(num_classes=5, device="cpu")
    preds, target = _auroc_inputs("multiclass", n=40)
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    tm.update(_t(preds), _t(target))
    bp, bt = _auroc_inputs("binary", n=40)
    _same_error(lambda: jm.update(jnp.asarray(bp), jnp.asarray(bt)), lambda: tm.update(_t(bp), _t(bt)))


def test_auroc_list_state_dict_jax_to_port_to_jax():
    batches = [_auroc_inputs("multiclass", "ties", seed=s, n=60) for s in (18, 19, 20)]
    jm = metrics_tpu.AUROC(num_classes=5)
    jm.persistent(True)
    for preds, target in batches[:2]:
        jm.update(jnp.asarray(preds), jnp.asarray(target))
    tm = metrics_tpu_torch.AUROC(num_classes=5, device="cpu")
    tm.persistent(True)
    load_jax_state_dict(tm, jm.state_dict())
    assert tm.mode == jm.mode and len(tm.preds) == len(jm.preds) == 2
    for k in ("preds", "target"):
        _assert(getattr(jm, k), getattr(tm, k))
    _assert(jm.compute(), tm.compute(), AREA_RTOL)

    preds, target = batches[2]
    tm.update(_t(preds), _t(target))
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    jm2 = metrics_tpu.AUROC(num_classes=5)
    jm2.persistent(True)
    jm2.load_state_dict(to_jax_state_dict(tm))
    _assert(jm2.compute(), tm.compute(), AREA_RTOL)
    _assert(jm.compute(), tm.compute(), AREA_RTOL)


# ---------------------------------------------------------- compute_on_cpu
@pytest.mark.parametrize("jit_update", [False, True])
@pytest.mark.parametrize("metric,kwargs,mode", [
    ("AUROC", dict(num_classes=5), "multiclass"),
    ("ROC", dict(num_classes=5), "multiclass"),
    ("CalibrationError", dict(n_bins=7), "multiclass"),
    ("AUC", dict(), "curve"),
])
def test_compute_on_cpu_equal_to_jax_with_list_states_on_the_cpu(metric, kwargs, mode, jit_update, monkeypatch):
    """The list states are on the CPU after each update, and moved there by
    every update (eager or ``jit_update``, which a list-state metric serves
    eagerly in both packages); the values are the JAX package's."""
    jm = getattr(metrics_tpu, metric)(compute_on_cpu=True, jit_update=jit_update, **kwargs)
    tm = getattr(metrics_tpu_torch, metric)(compute_on_cpu=True, jit_update=jit_update, device="cpu", **kwargs)
    assert tm.compute_on_cpu is True
    moves = []
    real = tm._move_list_states_to_cpu
    monkeypatch.setattr(tm, "_move_list_states_to_cpu", lambda: (moves.append(1), real())[1])
    rng = np.random.RandomState(21)
    for step in range(3):
        if mode == "curve":
            x = np.sort(rng.rand(10)).astype(np.float32) + step
            args = (x, rng.rand(10).astype(np.float32))
        else:
            args = _auroc_inputs(mode, "ties", seed=22 + step, n=50)
        jm.update(*(jnp.asarray(a) for a in args))
        tm.update(*(_t(a) for a in args))
        assert len(moves) == step + 1
        for k, default in tm._defaults.items():
            assert isinstance(default, list)
            assert len(getattr(tm, k)) == step + 1 and all(v.device.type == "cpu" for v in getattr(tm, k))
    assert tm.dispatch_stats["dispatches"] == jm.dispatch_stats["dispatches"] == 3
    assert tm.dispatch_stats["retraces"] == jm.dispatch_stats["retraces"] == 0
    rtol = 1e-5 if metric != "ROC" else None
    _assert(jm.compute(), tm.compute(), rtol)


def test_compute_on_cpu_leaves_tensor_states_and_checks_its_argument_like_jax():
    tm = metrics_tpu_torch.KLDivergence(compute_on_cpu=True, device="cpu")
    jm = metrics_tpu.KLDivergence(compute_on_cpu=True)
    p = np.random.RandomState(23).rand(6, 4).astype(np.float32)
    q = np.random.RandomState(24).rand(6, 4).astype(np.float32)
    tm.update(_t(p), _t(q))
    jm.update(jnp.asarray(p), jnp.asarray(q))
    assert isinstance(tm.measures, torch.Tensor)
    _assert(jm.compute(), tm.compute(), AREA_RTOL)
    _same_error(lambda: metrics_tpu.AUROC(compute_on_cpu=1), lambda: metrics_tpu_torch.AUROC(compute_on_cpu=1, device="cpu"))


# ----------------------------------------------------------- collections
def _curve_collection(pkg, c, **kw):
    return pkg.MetricCollection({
        "acc": pkg.Accuracy(num_classes=c, average="macro", **kw),
        "auroc": pkg.AUROC(num_classes=c, **kw),
        "auroc_weighted": pkg.AUROC(num_classes=c, average="weighted", **kw),
        "ece": pkg.CalibrationError(n_bins=15, **kw),
        "mce": pkg.CalibrationError(n_bins=15, norm="max", **kw),
    })


def test_curve_collection_compute_groups_and_values_equal_to_jax():
    """The ImageNet curve-and-calibration collection at C = 10: the JAX
    package's three compute groups, and its values."""
    c = 10
    jc, tc = _curve_collection(metrics_tpu, c), _curve_collection(metrics_tpu_torch, c, device="cpu")
    rng = np.random.RandomState(25)
    for _ in range(3):
        logits = rng.randn(64, c).astype(np.float32)
        preds = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        target = rng.randint(0, c, 64)
        jc.update(jnp.asarray(preds), jnp.asarray(target))
        tc.update(_t(preds), _t(target))
    assert tc.compute_groups == jc.compute_groups == {0: ["acc"], 1: ["auroc", "auroc_weighted"], 2: ["ece", "mce"]}
    jv, tv = jc.compute(), tc.compute()
    assert jv.keys() == tv.keys()
    for k in jv:
        _assert(jv[k], tv[k], AREA_RTOL)
