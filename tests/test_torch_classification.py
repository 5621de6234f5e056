"""The port's classification slice held against the JAX package on the CPU.

The same seeded numpy inputs go through ``metrics_tpu`` and
``metrics_tpu_torch``. Counts (stat scores, confusion matrices, states)
must be exactly equal and of equal dtype. Float scores must agree to
``rtol=1e-6``: both are float32, but XLA and PyTorch sum the per-class
scores in another order, which moves the last bit or so.
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
from metrics_tpu_torch.interop import load_jax_state_dict, to_jax_state_dict
from metrics_tpu_torch.utilities.exceptions import StateCorruptionError

RTOL = 1e-6
C = 7


def _scores(n, c, seed):
    rng = np.random.RandomState(seed)
    return rng.rand(n, c).astype(np.float32), rng.randint(0, c, n)


def _pair(x):
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def _assert_same(jax_out, torch_out, exact):
    ref = np.asarray(jax_out)
    got = torch_out.numpy()
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert got.shape == ref.shape
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)


def _inputs(kind, n=96, c=C, seed=0):
    probs, labels = _scores(n, c, seed)
    if kind == "scores":
        return probs, labels
    if kind == "nan_scores":  # every 7th row holds a NaN: its predicted class is C
        probs[::7, seed % c] = np.nan
        return probs, labels
    if kind == "labels":
        return probs.argmax(1), labels
    raise ValueError(kind)


# ------------------------------------------------------------- functional
@pytest.mark.parametrize("kind", ["scores", "labels", "nan_scores"])
@pytest.mark.parametrize("reduce", ["micro", "macro", "samples"])
@pytest.mark.parametrize("ignore_index", [None, 2])
def test_functional_stat_scores(kind, reduce, ignore_index):
    preds, target = _inputs(kind)
    (jp, tp), (jt, tt) = _pair(preds), _pair(target)
    kwargs = dict(reduce=reduce, num_classes=C, ignore_index=ignore_index)
    _assert_same(jF.stat_scores(jp, jt, **kwargs), tF.stat_scores(tp, tt, **kwargs), exact=True)


@pytest.mark.parametrize("kind", ["scores", "labels", "nan_scores"])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("ignore_index", [None, 3, -1])
def test_functional_accuracy(kind, average, ignore_index):
    preds, target = _inputs(kind, seed=5)
    if ignore_index == -1:
        target = target.copy()
        target[::5] = -1
    (jp, tp), (jt, tt) = _pair(preds), _pair(target)
    kwargs = dict(average=average, num_classes=C, ignore_index=ignore_index)
    _assert_same(jF.accuracy(jp, jt, **kwargs), tF.accuracy(tp, tt, **kwargs), exact=False)


def test_functional_accuracy_top_k_and_subset():
    preds, target = _inputs("scores", seed=6)
    (jp, tp), (jt, tt) = _pair(preds), _pair(target)
    _assert_same(jF.accuracy(jp, jt, top_k=2), tF.accuracy(tp, tt, top_k=2), exact=False)
    rng = np.random.RandomState(6)
    ml_preds, ml_target = rng.rand(40, 4).astype(np.float32), rng.randint(0, 2, (40, 4))
    (jp, tp), (jt, tt) = _pair(ml_preds), _pair(ml_target)
    for subset in (False, True):
        _assert_same(
            jF.accuracy(jp, jt, subset_accuracy=subset), tF.accuracy(tp, tt, subset_accuracy=subset), exact=False
        )


def test_functional_accuracy_ties_break_to_the_first_class():
    preds = np.array([[0.5, 0.5, 0.0], [0.2, 0.4, 0.4], [0.3, 0.3, 0.3]], np.float32)
    target = np.array([1, 2, 0])
    (jp, tp), (jt, tt) = _pair(preds), _pair(target)
    _assert_same(
        jF.stat_scores(jp, jt, reduce="macro", num_classes=3),
        tF.stat_scores(tp, tt, reduce="macro", num_classes=3),
        exact=True,
    )


@pytest.mark.parametrize("kind", ["scores", "labels"])
@pytest.mark.parametrize("normalize", [None, "true", "pred", "all"])
def test_functional_confusion_matrix(kind, normalize):
    preds, target = _inputs(kind, n=64, seed=7)
    (jp, tp), (jt, tt) = _pair(preds), _pair(target)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # both warn about the NaN cells of absent classes
        ref = jF.confusion_matrix(jp, jt, num_classes=C, normalize=normalize)
        got = tF.confusion_matrix(tp, tt, num_classes=C, normalize=normalize)
    _assert_same(ref, got, exact=normalize is None)


def test_functional_confusion_matrix_binary_and_multilabel():
    rng = np.random.RandomState(8)
    probs, labels = rng.rand(50).astype(np.float32), rng.randint(0, 2, 50)
    (jp, tp), (jt, tt) = _pair(probs), _pair(labels)
    _assert_same(jF.confusion_matrix(jp, jt, num_classes=2), tF.confusion_matrix(tp, tt, num_classes=2), exact=True)
    ml_probs, ml_labels = rng.rand(50, 3).astype(np.float32), rng.randint(0, 2, (50, 3))
    (jp, tp), (jt, tt) = _pair(ml_probs), _pair(ml_labels)
    _assert_same(
        jF.confusion_matrix(jp, jt, num_classes=3, multilabel=True),
        tF.confusion_matrix(tp, tt, num_classes=3, multilabel=True),
        exact=True,
    )


# ---------------------------------------------------------------- modules
def _batches(kind, seed, sizes=(64, 64, 37)):
    out = []
    for i, n in enumerate(sizes):
        out.append(_inputs(kind, n=n, seed=seed + i))
    return out


def _assert_states(jm, tm):
    for name in jm._defaults:
        ref, got = getattr(jm, name), getattr(tm, name)
        if isinstance(ref, list):  # list states: equal entries in equal order
            assert isinstance(got, list) and len(got) == len(ref)
            ref, got = jnp.concatenate(ref), torch.cat(got)
        _assert_same(ref, got, exact=True)


def _drive(make_jax, make_torch, batches, exact):
    jm, tm = make_jax(), make_torch()
    for i, (preds, target) in enumerate(batches):
        (jp, tp), (jt, tt) = _pair(preds), _pair(target)
        if i == 1:  # forward: batch value, and the batch accumulated once
            _assert_same(jm(jp, jt), tm(tp, tt), exact=exact)
        else:
            jm.update(jp, jt)
            tm.update(tp, tt)
        _assert_states(jm, tm)
        _assert_same(jm.compute(), tm.compute(), exact=exact)
    assert tm._update_count == len(batches) == jm._update_count
    return jm, tm


@pytest.mark.parametrize("kind", ["scores", "labels", "nan_scores"])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
def test_accuracy_module(kind, average):
    kwargs = dict(num_classes=C, average=average)
    jm, tm = _drive(
        lambda: metrics_tpu.Accuracy(**kwargs),
        lambda: metrics_tpu_torch.Accuracy(device="cpu", **kwargs),
        _batches(kind, seed=11),
        exact=False,
    )
    version = tm.state_version
    tm.reset()
    jm.reset()
    assert tm.state_version > version and tm._update_count == 0
    _assert_states(jm, tm)
    with pytest.warns(UserWarning, match="called before the ``update``"):
        tm.compute()


@pytest.mark.parametrize("reduce", ["micro", "macro", "samples"])
def test_stat_scores_module(reduce):
    kwargs = dict(num_classes=C, reduce=reduce)
    _drive(
        lambda: metrics_tpu.StatScores(**kwargs),
        lambda: metrics_tpu_torch.StatScores(device="cpu", **kwargs),
        _batches("scores", seed=13),
        exact=True,
    )


@pytest.mark.parametrize("reduce", ["micro", "macro", "samples"])
def test_stat_scores_module_nan_score_rows(reduce):
    kwargs = dict(num_classes=C, reduce=reduce)
    _drive(
        lambda: metrics_tpu.StatScores(**kwargs),
        lambda: metrics_tpu_torch.StatScores(device="cpu", **kwargs),
        _batches("nan_scores", seed=13),
        exact=True,
    )


def test_nan_score_row_counts_as_the_jax_scatter_does():
    # row 1 = [nan, .5, .5] with label 0: its predicted class is C, which JAX's scatter adds to tp[0]
    preds = np.array([[0.2, 0.5, 0.3], [np.nan, 0.5, 0.5], [0.1, 0.1, 0.8], [0.6, 0.3, 0.1]], np.float32)
    target = np.array([1, 0, 2, 0])
    (jp, tp), (jt, tt) = _pair(preds), _pair(target)
    got = tF.stat_scores(tp, tt, reduce="macro", num_classes=3)
    _assert_same(jF.stat_scores(jp, jt, reduce="macro", num_classes=3), got, exact=True)
    # class 0: rows 1 and 3 are labelled 0; the hit of row 3 and the scatter's add of row 1 make tp = 2
    assert got[0].tolist() == [2, -1, 3, 0, 2]
    _assert_same(jF.accuracy(jp, jt, average="macro", num_classes=3),
                 tF.accuracy(tp, tt, average="macro", num_classes=3), exact=False)


@pytest.mark.parametrize("update_method", ["bincount", "matmul"])
@pytest.mark.parametrize("kind", ["scores", "labels"])
def test_confusion_matrix_module(update_method, kind):
    kwargs = dict(num_classes=C, update_method=update_method)
    jm, tm = _drive(
        lambda: metrics_tpu.ConfusionMatrix(**kwargs),
        lambda: metrics_tpu_torch.ConfusionMatrix(device="cpu", **kwargs),
        _batches(kind, seed=17),
        exact=True,
    )
    tm.reset()
    assert int(tm.confmat.sum()) == 0 and tm.confmat.dtype == torch.int32


def test_confusion_matrix_update_methods_agree():
    a = metrics_tpu_torch.ConfusionMatrix(num_classes=C, device="cpu")
    b = metrics_tpu_torch.ConfusionMatrix(num_classes=C, update_method="matmul", device="cpu")
    for preds, target in _batches("scores", seed=19):
        a.update(torch.from_numpy(preds), torch.from_numpy(target))
        b.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert torch.equal(a.compute(), b.compute())


def test_pure_functions_match_the_stateful_path():
    m = metrics_tpu_torch.Accuracy(num_classes=C, average="macro", device="cpu")
    batches = [(torch.from_numpy(p), torch.from_numpy(t)) for p, t in _batches("scores", seed=23)]
    state_a = m.pure_update(m.default_state(), *batches[0])
    state_b = m.pure_update(m.default_state(), *batches[1])
    assert m._update_count == 0 and int(m.tp.sum()) == 0  # the metric's own state is untouched
    for p, t in batches[:2]:
        m.update(p, t)
    merged = m.pure_merge(state_a, state_b)
    for name in ("tp", "fp", "tn", "fn"):
        assert torch.equal(merged[name], getattr(m, name))
    assert torch.equal(m.pure_compute(merged), m.compute())


# ------------------------------------------- segmentation inputs: the label route
SEG_C = 6


def _seg_inputs(kind, seed, ignore_index=None, n=3, hw=(5, 7)):
    """``(n, SEG_C, *hw)`` float32 scores, or their argmax as ``(n, *hw)`` int
    labels, and ``(n, *hw)`` int targets; a negative ``ignore_index`` marks
    every 4th target position."""
    rng = np.random.RandomState(seed)
    scores = rng.rand(n, SEG_C, *hw).astype(np.float32)
    target = rng.randint(0, SEG_C, (n,) + hw)
    if kind == "ties":  # a coarse grid: many positions' maxima tie, and the first class wins
        scores = np.round(scores * 2) / 2
    elif kind == "nan_scores":  # every 5th position holds a NaN in one class, which is then its argmax
        scores[:, seed % SEG_C][np.arange(target.size).reshape(target.shape) % 5 == 0] = np.nan
    if ignore_index is not None and ignore_index < 0:
        target.reshape(-1)[::4] = ignore_index
    return (scores.argmax(1) if kind == "labels" else scores), target


_SEG_METRICS = {
    **{f"Accuracy-{avg}": ("Accuracy", dict(average=avg, mdmc_average="global"), (None, 2))
       for avg in ("micro", "macro", "weighted", "none")},
    **{f"StatScores-{red}": ("StatScores", dict(reduce=red, mdmc_reduce="global"), (None, 2))
       for red in ("micro", "macro")},
    **{f"JaccardIndex-{um}": ("JaccardIndex", dict(update_method=um), (None, 2)) for um in ("bincount", "matmul")},
    **{f"ConfusionMatrix-{um}": ("ConfusionMatrix", dict(update_method=um), (None,)) for um in ("bincount", "matmul")},
}
_SEG_CASES = [(name, ig) for name, (_, _, ignores) in _SEG_METRICS.items() for ig in ignores]


@pytest.mark.parametrize("kind", ["scores", "labels", "ties", "nan_scores"])
@pytest.mark.parametrize("name,ignore_index", _SEG_CASES)
def test_segmentation_inputs_take_the_label_route_and_equal_jax(name, ignore_index, kind):
    """``(B, C, H, W)`` scores and ``(B, H, W)`` labels count from class labels: states exactly JAX's
    one-hot counts, values to RTOL, every update a ``format:labels``."""
    from metrics_tpu_torch import telemetry

    metric, kwargs, _ = _SEG_METRICS[name]
    kwargs = dict(kwargs, num_classes=SEG_C)
    jax_kwargs = {k: v for k, v in kwargs.items() if k != "update_method"}
    if ignore_index is not None:
        kwargs["ignore_index"] = jax_kwargs["ignore_index"] = ignore_index
    batches = [_seg_inputs(kind, seed=41 + i, ignore_index=ignore_index) for i in range(3)]
    telemetry.reset_counters()
    _drive(lambda: getattr(metrics_tpu, metric)(**jax_kwargs),
           lambda: getattr(metrics_tpu_torch, metric)(device="cpu", **kwargs),
           batches, exact=metric in ("StatScores", "ConfusionMatrix"))
    counters = telemetry.snapshot()
    assert counters.get("format:labels", 0) > 0 and "format:onehot" not in counters


@pytest.mark.parametrize("kind", ["scores", "labels", "ties", "nan_scores"])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
def test_functional_accuracy_of_segmentation_inputs_with_a_negative_ignore_index(kind, average):
    """A negative ``ignore_index`` (the functional's; a module refuses one) arrives at the label route as a
    row mask."""
    from metrics_tpu_torch import telemetry

    preds, target = _seg_inputs(kind, seed=45, ignore_index=-1)
    (jp, tp), (jt, tt) = _pair(preds), _pair(target)
    kwargs = dict(average=average, num_classes=SEG_C, ignore_index=-1)
    telemetry.reset_counters()
    _assert_same(jF.accuracy(jp, jt, **kwargs), tF.accuracy(tp, tt, **kwargs), exact=False)
    assert telemetry.snapshot()["format:labels"] == 1


@pytest.mark.parametrize("kind", ["scores", "labels"])
@pytest.mark.parametrize("average", ["micro", "macro"])
@pytest.mark.parametrize("ignore_index", [None, 2])
def test_masked_update_of_segmentation_inputs_equals_jax(kind, average, ignore_index):
    """The engine's padded batch: the last sample's positions count nothing, as in the JAX package."""
    kwargs = dict(num_classes=SEG_C, average=average, mdmc_average="global", ignore_index=ignore_index)
    jm, tm = metrics_tpu.Accuracy(**kwargs), metrics_tpu_torch.Accuracy(device="cpu", **kwargs)
    mask = np.array([True, True, False])
    for seed in (51, 52):
        preds, target = _seg_inputs(kind, seed=seed)
        (jp, tp), (jt, tt) = _pair(preds), _pair(target)
        jm._masked_update(jnp.asarray(mask), jp, jt)
        tm._masked_update(torch.from_numpy(mask), tp, tt)
        _assert_states(jm, tm)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # both warn: a masked update leaves the update count as it was
        _assert_same(jm.compute(), tm.compute(), exact=False)


def _outside_labels(kind, seed):
    """Segmentation inputs whose targets, and integer predictions, hold labels outside ``[0, SEG_C)``."""
    preds, target = _seg_inputs(kind, seed=seed)
    outside = target.reshape(-1)[::3]
    outside[:] = np.resize([-3, SEG_C, SEG_C + 4, -1, 2**32 + 1], outside.size)  # 2**32 + 1 is 1 as an int32
    if kind == "labels":
        outside = preds.reshape(-1)[1::4]
        outside[:] = np.resize([SEG_C, -2, 2**33], outside.size)
    return torch.from_numpy(preds), torch.from_numpy(target)


@pytest.mark.parametrize("kind", ["scores", "labels"])
@pytest.mark.parametrize("reduce", ["micro", "macro"])
@pytest.mark.parametrize("ignore_index", [None, 0, SEG_C - 1])
@pytest.mark.parametrize("masked", [False, True])
def test_label_route_counts_labels_outside_the_classes_as_the_one_hot_route(kind, reduce, ignore_index, masked):
    """Under ``tracing()`` (an engine's program: no value checks) a label outside ``[0, C)`` is the one-hot
    route's all-zero row: the label route's int32 counts equal that route's, bit for bit."""
    from metrics_tpu_torch.functional.classification.stat_scores import _stat_scores_update
    from metrics_tpu_torch.utilities.checks import tracing
    from tests.helpers.onehot_route import onehot_stat_scores

    preds, target = _outside_labels(kind, seed=61)
    mask = torch.tensor([True, False, True]) if masked else None
    with tracing():
        got = _stat_scores_update(preds, target, reduce=reduce, mdmc_reduce="global", num_classes=SEG_C,
                                  ignore_index=ignore_index, sample_mask=mask)
        want = onehot_stat_scores(preds, target, reduce, num_classes=SEG_C, ignore_index=ignore_index,
                                  sample_mask=mask)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.int32 and g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("kind", ["scores", "labels"])
@pytest.mark.parametrize("update_method", ["bincount", "matmul"])
def test_label_route_confusion_matrix_puts_labels_outside_the_classes_in_class_0(kind, update_method):
    """Under ``tracing()`` a label outside ``[0, C)`` counts as class 0, the argmax of an all-zero one-hot."""
    from metrics_tpu_torch.functional.classification.confusion_matrix import (
        _confusion_matrix_update,
        _confusion_matrix_update_matmul,
    )
    from metrics_tpu_torch.utilities.checks import tracing
    from tests.helpers.onehot_route import onehot_confmat

    preds, target = _outside_labels(kind, seed=62)
    update = _confusion_matrix_update if update_method == "bincount" else _confusion_matrix_update_matmul
    with tracing():
        got = update(preds, target, SEG_C)
        want = onehot_confmat(preds, target, SEG_C)
    assert got.dtype == want.dtype == torch.int32 and torch.equal(got, want)
    assert int(got.sum()) == target.numel()  # every position counted, those outside in class 0


def _route_counts():
    from metrics_tpu_torch import telemetry

    counters = telemetry.snapshot()
    return counters.get("format:labels", 0), counters.get("format:onehot", 0)


@pytest.mark.parametrize("engine", [False, True])
def test_format_route_counters_tick_once_a_member_update(engine):
    """The cells' collection: eagerly each member's update ticks ``format:labels`` itself; through the
    fused engine the program's routes ride its ``update`` span, once a call."""
    from metrics_tpu_torch import telemetry

    mc = metrics_tpu_torch.MetricCollection(
        [metrics_tpu_torch.JaccardIndex(num_classes=SEG_C, ignore_index=SEG_C - 1, update_method="matmul",
                                        jit_update=engine, device="cpu"),
         metrics_tpu_torch.Accuracy(num_classes=SEG_C, ignore_index=SEG_C - 1, mdmc_average="global",
                                    jit_update=engine, device="cpu")],
        fused_update=engine, compute_groups=True)
    telemetry.reset_counters()
    with telemetry.instrument() as session:
        for seed in range(3):
            mc.update(*(torch.from_numpy(x) for x in _seg_inputs("scores", seed=70 + seed)))
    assert _route_counts() == (6, 0)
    if engine:
        spans = session.spans(name="update")
        assert [(s.owner, s.kind, s.attrs["format_labels"]) for s in spans] == [("MetricCollection", "fused-aot", 2)] * 3
        assert all("format_onehot" not in s.attrs for s in spans)


@pytest.mark.parametrize("kwargs", [dict(mdmc_average="samplewise"), dict(top_k=2), dict(subset_accuracy=True)],
                         ids=["samplewise", "top_k=2", "subset"])
def test_inputs_left_on_the_one_hot_route_tick_format_onehot(kwargs):
    from metrics_tpu_torch import telemetry

    m = metrics_tpu_torch.Accuracy(num_classes=SEG_C, device="cpu", **kwargs)
    telemetry.reset_counters()
    for seed in range(2):
        m.update(*(torch.from_numpy(x) for x in _seg_inputs("scores", seed=80 + seed)))
    assert _route_counts() == (0, 2)


# ------------------------------------------------------------------ errors
_BAD_INPUTS = {
    "float target": (np.random.RandomState(0).rand(8, C).astype(np.float32), np.zeros(8, np.float32)),
    "negative target": (np.random.RandomState(0).rand(8, C).astype(np.float32), np.full(8, -1)),
    "label >= C": (np.random.RandomState(0).rand(8, C).astype(np.float32), np.full(8, C)),
    "batch mismatch": (np.random.RandomState(0).rand(8, C).astype(np.float32), np.zeros(6, np.int64)),
    "shape mismatch": (np.random.RandomState(0).rand(8, C, 2).astype(np.float32), np.zeros((8, 3), np.int64)),
    "int preds negative": (np.full(8, -2), np.zeros(8, np.int64)),
}


@pytest.mark.parametrize("case", sorted(_BAD_INPUTS))
@pytest.mark.parametrize("metric", ["Accuracy", "ConfusionMatrix"])
def test_same_input_errors(case, metric):
    preds, target = _BAD_INPUTS[case]
    (jp, tp), (jt, tt) = _pair(preds), _pair(target)
    kwargs = dict(num_classes=C)
    if metric == "ConfusionMatrix":
        kwargs["update_method"] = "matmul"
    with pytest.raises(Exception) as jax_err:
        getattr(metrics_tpu, metric)(**kwargs).update(jp, jt)
    with pytest.raises(Exception) as torch_err:
        getattr(metrics_tpu_torch, metric)(device="cpu", **kwargs).update(tp, tt)
    assert type(torch_err.value) is type(jax_err.value)
    assert str(torch_err.value) == str(jax_err.value)


def test_mode_change_is_refused_like_jax():
    tm = metrics_tpu_torch.Accuracy(device="cpu")
    tm.update(torch.rand(4), torch.tensor([0, 1, 1, 0]))
    with pytest.raises(ValueError, match="You can not use"):
        tm.update(torch.rand(4, 3), torch.tensor([0, 1, 2, 0]))


@pytest.mark.parametrize(
    "kwargs,item,refusal",
    [
        # compute_on_cpu is ported with the curve metrics (ROADMAP.md, Queue A item 6): taken, as in the JAX package
        ({"compute_on_cpu": True}, "curve metrics", None),
        # distributed sync is ported (ROADMAP.md, Queue A item 5): its options are taken, as in the JAX package
        ({"sync_env": metrics_tpu_torch.parallel.NoOpEnv()}, "distributed sync", None),
        ({"dist_sync_fn": lambda x, env: [x]}, "distributed sync", None),
        ({"sync_dtype": "bfloat16"}, "distributed sync", None),
        ({"sync_precision": "int8"}, "distributed sync", None),
        ({"dist_sync_on_step": True}, "distributed sync", None),
        # a mesh-axis name, where the port takes a torch.distributed process group, is refused
        ({"process_group": "dp"}, "distributed sync", (ValueError, "process group")),
        ({"shard_state": "dp"}, "distributed sync", (ValueError, "process group")),
    ],
    # the ids the cases had beside the jit_update one, which the engines (tests/test_torch_dispatch.py) retired
    ids=[f"kwargs{i}-{item}" for i, item in enumerate(["curve metrics"] + ["distributed sync"] * 7, start=1)],
)
def test_unported_options_raise_naming_the_roadmap_item(kwargs, item, refusal):
    """An option of a module not ported yet raises naming its ROADMAP.md item;
    ``compute_on_cpu`` and the distributed-sync options are ported and taken."""
    if refusal is not None:
        with pytest.raises(refusal[0], match=refusal[1]):
            metrics_tpu_torch.ConfusionMatrix(num_classes=3, device="cpu", **kwargs)
        return
    m = metrics_tpu_torch.ConfusionMatrix(num_classes=3, device="cpu", **kwargs)
    m.update(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
    assert m.compute().tolist() == [[1, 0, 0], [0, 1, 1], [0, 0, 0]]


def test_inputs_on_another_device_raise():
    m = metrics_tpu_torch.Accuracy(num_classes=3, device="cpu")
    meta = torch.empty(4, 3, device="meta")
    with pytest.raises(RuntimeError, match="metric's device"):
        m.update(meta, torch.zeros(4, dtype=torch.int64))


# ------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("metric,kwargs", [
    ("Accuracy", dict(num_classes=C, average="macro")),
    ("ConfusionMatrix", dict(num_classes=C, update_method="matmul")),
])
def test_state_dict_jax_to_port_to_jax(metric, kwargs):
    batches = _batches("scores", seed=29)
    jm = getattr(metrics_tpu, metric)(**kwargs)
    jm.persistent(True)
    for preds, target in batches[:2]:
        jm.update(*(_pair(preds)[0], _pair(target)[0]))
    payload = jm.state_dict()

    tm = getattr(metrics_tpu_torch, metric)(device="cpu", **kwargs)
    tm.persistent(True)
    load_jax_state_dict(tm, payload)
    _assert_states(jm, tm)
    _assert_same(jm.compute(), tm.compute(), exact=metric == "ConfusionMatrix")

    preds, target = batches[2]
    tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    back = to_jax_state_dict(tm)
    assert all(isinstance(v, np.ndarray) for k, v in back.items() if not k.startswith(("aux:", "__checksum__")))
    jm2 = getattr(metrics_tpu, metric)(**kwargs)
    jm2.persistent(True)
    jm2.load_state_dict(back)  # verifies the port's checksums
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    _assert_states(jm, tm)
    _assert_states(jm2, tm)
    _assert_same(jm2.compute(), tm.compute(), exact=metric == "ConfusionMatrix")
    # both packages write the same checksum strings for the same state
    assert {k: v for k, v in jm.state_dict().items() if k.startswith("__checksum__")} == {
        k: v for k, v in tm.state_dict().items() if k.startswith("__checksum__")
    }


def test_corrupted_payload_is_refused():
    jm = metrics_tpu.Accuracy(num_classes=C, average="macro")
    jm.persistent(True)
    preds, target = _inputs("scores")
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    payload = dict(jm.state_dict())
    payload["tp"] = np.asarray(payload["tp"]).copy()
    payload["tp"][0] += 1
    tm = metrics_tpu_torch.Accuracy(num_classes=C, average="macro", device="cpu")
    with pytest.raises(StateCorruptionError, match="'tp'"):
        load_jax_state_dict(tm, payload)
    assert int(tm.tp.sum()) == 0


def test_port_state_dict_round_trip_and_clone():
    tm = metrics_tpu_torch.Accuracy(num_classes=C, average="macro", device="cpu")
    tm.persistent(True)
    for preds, target in _batches("scores", seed=31):
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    fresh = metrics_tpu_torch.Accuracy(num_classes=C, average="macro", device="cpu")
    fresh.load_state_dict(tm.state_dict())
    assert fresh.mode == tm.mode and torch.equal(fresh.compute(), tm.compute())
    copy = tm.clone()
    copy.update(*(torch.from_numpy(x) for x in _inputs("scores", seed=1)))
    assert copy._update_count == tm._update_count + 1 and not torch.equal(copy.tp, tm.tp)
