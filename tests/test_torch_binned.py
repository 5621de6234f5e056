"""The port's binned precision-recall slice held against the JAX package on the CPU.

The same seeded numpy inputs go through ``metrics_tpu`` and
``metrics_tpu_torch``. Counts (the ``binned_stats`` results and the
``TPs/FPs/FNs`` states) must be exactly equal and of equal dtype; curves and
average precisions must agree to ``rtol=1e-6``, because XLA and PyTorch sum
float32 terms in another order. The ``binned_stats`` plain version is held
against both JAX formulations: the XLA path (``force_pallas=False``) and the
Pallas kernel body in interpret mode, called directly so that the
registry's fallback cannot hide a failure. The CUDA kernel itself runs only
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
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
from metrics_tpu.ops.binned_stats import _binned_stat_scores_pallas
from metrics_tpu.ops.binned_stats import binned_stat_scores as jax_binned_stat_scores
from metrics_tpu_torch.classification.binned_precision_recall import _linspace_thresholds
from metrics_tpu_torch.interop import load_jax_state_dict, to_jax_state_dict
from metrics_tpu_torch.ops import binned_stat_scores, launches, reset_launches

RTOL = 1e-6


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_same(ref, got, exact):
    """``ref`` (JAX) and ``got`` (port): arrays, or lists/tuples of them."""
    if isinstance(ref, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(ref)
        for r, g in zip(ref, got):
            _assert_same(r, g, exact)
        return
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)


def _assert_binned(preds, target, thr):
    """The port's plain version against JAX's XLA path and its Pallas kernel.

    The Pallas kernel pads its batch with ``-inf`` scores, which a ``-inf``
    threshold counts; such thresholds are held against the XLA path only.
    """
    got = binned_stat_scores(_t(preds), _t(target), _t(thr))
    jp, jt, jthr = jnp.asarray(preds), jnp.asarray(target), jnp.asarray(thr)
    xla = jax_binned_stat_scores(jp, jt, jthr, force_pallas=False)
    _assert_same(xla, got, exact=True)
    if preds.shape[0] > 0 and not np.isneginf(thr).any():
        pallas = _binned_stat_scores_pallas(jp, jt == 1, jthr, interpret=True)
        _assert_same(pallas, got, exact=True)


# ----------------------------------------------------------- binned_stats
@pytest.mark.parametrize(
    "n,c,t",
    # the grids of the JAX package's Pallas tests (test_pallas_binned.py and test_kernel_parity.py)
    [(n, c, t) for n in (1, 100, 128, 300) for c, t in ((1, 5), (5, 17), (3, 128))] + [(200, 3, 17)],
)
def test_binned_plain_matches_jax_xla_and_pallas(n, c, t):
    rng = np.random.RandomState(n + c + t)
    preds = rng.rand(n, c).astype(np.float32)
    target = rng.randint(0, 2, (n, c))
    _assert_binned(preds, target, np.asarray(jnp.linspace(0, 1, t)))


def test_binned_boundary_scores_hit_their_threshold():
    preds = np.array([[0.0], [0.25], [0.5], [1.0]], np.float32)
    target = np.array([[1], [0], [1], [1]])
    _assert_binned(preds, target, np.array([0.0, 0.25, 0.5, 1.0], np.float32))


def test_binned_nan_and_inf_scores():
    rng = np.random.RandomState(4)
    preds = rng.rand(40, 4).astype(np.float32)
    preds[::5, 0] = np.nan
    preds[1::5, 1] = np.inf
    preds[2::5, 2] = -np.inf
    target = rng.randint(0, 2, (40, 4))
    target[::5, 0] = 1  # a NaN score with a positive target still counts in pos, so in fn
    thr = np.array([0.0, 0.5, 1.0, np.inf], np.float32)
    _assert_binned(preds, target, thr)
    _assert_binned(preds, target, np.concatenate([[-np.inf], thr]).astype(np.float32))
    tp, _, fn = binned_stat_scores(_t(preds), _t(target), _t(thr))
    assert int(tp[0].max()) + 8 <= int(target[:, 0].sum()) and int(fn[0].min()) >= 8


def test_binned_unsorted_repeated_thresholds_and_non_binary_targets():
    rng = np.random.RandomState(5)
    preds = rng.rand(150, 6).astype(np.float32)
    preds[:20] = np.array([0.5, 0.1, 0.9], np.float32)[rng.randint(0, 3, (20, 6))]
    target = rng.randint(0, 3, (150, 6))  # 2 is not the positive label
    thr = np.array([0.5, 0.1, 0.5, 0.9, 0.0, 1.0, 0.3], np.float32)
    _assert_binned(preds, target, thr)


_SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, np.nan], np.float32)


def _edge_scores(rng, n, c):
    """Scores on a 1/8 grid (so that many sit exactly on a threshold), with +-0, +-inf and NaN among them."""
    preds = (np.round(rng.rand(n, c) * 8) / 8).astype(np.float32)
    special = rng.rand(n, c) < 0.15
    preds[special] = _SPECIALS[rng.randint(0, _SPECIALS.size, special.sum())]
    return preds


# unsorted, with repeats, NaN, +-inf and -0.0 beside +0.0
_EDGE_THRESHOLDS = {
    "nan thresholds": np.array([0.25, np.nan, 0.5, np.nan, 0.75], np.float32),
    "signed zeros": np.array([-0.0, 0.5, 0.0, -0.0, 1.0], np.float32),
    "unsorted mix": np.array([0.5, np.nan, -np.inf, 0.125, 0.5, np.inf, -0.0, 1.0, 0.0, np.nan, 0.125, np.inf],
                             np.float32),
    "unsorted mix, no -inf": np.array([0.5, np.nan, 0.125, 0.5, np.inf, -0.0, 1.0, 0.0, np.nan, 0.125, np.inf],
                                      np.float32),
}


@pytest.mark.parametrize("case", sorted(_EDGE_THRESHOLDS))
@pytest.mark.parametrize("n,c", [(1, 3), (64, 5), (300, 9)])
def test_binned_edge_thresholds_and_scores_match_jax(case, n, c):
    # the Pallas body is held too where no -inf threshold meets its -inf padding rows (_assert_binned)
    rng = np.random.RandomState(n + c + len(case))
    _assert_binned(_edge_scores(rng, n, c), rng.randint(0, 3, (n, c)), _EDGE_THRESHOLDS[case])


def _ascending_key(x: torch.Tensor) -> torch.Tensor:
    """The kernel's order-preserving 32-bit key of float32 ``x``, in int64:
    ascending in the value, -0.0 as +0.0, NaN last."""
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = torch.where(x == 0, 0, bits)
    key = torch.where(bits >= 2**31, ~bits & 0xFFFFFFFF, bits | 2**31)
    return torch.where(torch.isnan(x), 0xFFFFFFFF, key)


def _histogram_model(preds: torch.Tensor, target: torch.Tensor, thr: torch.Tensor):
    """The arithmetic of the kernel's histogram branch in plain PyTorch.

    Sort the thresholds by their key, ties in index order (the kernel's
    64-bit composites); give each score its bin k, the number of sorted
    non-NaN thresholds at or below it, and NaN scores bin 0; histogram k per
    class, once for every row and once for the positives; suffix-sum, so
    that sorted position j counts the rows with k > j; scatter back to the
    thresholds' own columns.
    """
    n, c = preds.shape
    t = thr.shape[0]
    order = torch.argsort(_ascending_key(thr), stable=True)
    valid = int((~torch.isnan(thr)).sum())
    k = torch.searchsorted(thr[order][:valid].contiguous(), preds.contiguous(), right=True)
    k = torch.where(torch.isnan(preds), 0, k)
    y = target == 1
    flat = (torch.arange(c)[None, :] * (t + 1) + k).reshape(-1)
    hist_p = torch.bincount(flat, minlength=c * (t + 1)).reshape(c, t + 1)
    hist_tp = torch.bincount(flat[y.reshape(-1)], minlength=c * (t + 1)).reshape(c, t + 1)
    suffix_p, suffix_tp = (h.flip(1).cumsum(1).flip(1) for h in (hist_p, hist_tp))
    tp, p = torch.empty((c, t), dtype=torch.int64), torch.empty((c, t), dtype=torch.int64)
    tp[:, order], p[:, order] = suffix_tp[:, 1:], suffix_p[:, 1:]
    pos = suffix_tp[:, :1]
    return tp.float(), (p - tp).float(), (pos - tp).float()


@pytest.mark.parametrize("case", sorted(_EDGE_THRESHOLDS) + ["linspace 100", "one threshold"])
@pytest.mark.parametrize("n,c", [(1, 3), (64, 5), (300, 9)])
def test_histogram_model_of_the_kernel_matches_jax(case, n, c):
    thr = {"linspace 100": np.array(jnp.linspace(0, 1, 100)), "one threshold": np.array([0.5], np.float32)}.get(
        case, _EDGE_THRESHOLDS.get(case))
    rng = np.random.RandomState(7 * n + c)
    preds, target = _edge_scores(rng, n, c), rng.randint(0, 3, (n, c))
    got = _histogram_model(_t(preds), _t(target), _t(thr))
    ref = jax_binned_stat_scores(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(thr), force_pallas=False)
    _assert_same(ref, got, exact=True)
    _assert_same(ref, binned_stat_scores(_t(preds), _t(target), _t(thr)), exact=True)


def test_ascending_key_orders_like_the_values():
    x = torch.tensor([np.nan, np.inf, 1.0, 1e-45, 0.0, -0.0, -1e-45, -1.0, -np.inf], dtype=torch.float32)
    key = _ascending_key(x).tolist()
    assert key[0] == 0xFFFFFFFF and key[4] == key[5] == 2**31
    assert key[1] > key[2] > key[3] > key[4] > key[6] > key[7] > key[8] >= 0


def test_binned_empty_batch_gives_zeros():
    empty = np.zeros((0, 3), np.float32)
    out = binned_stat_scores(_t(empty), _t(empty.astype(np.int64)), _linspace_thresholds(5))
    for o in out:
        assert o.shape == (3, 5) and o.dtype == torch.float32 and int(o.abs().sum()) == 0
    _assert_binned(empty, empty.astype(np.int64), np.asarray(jnp.linspace(0, 1, 5)))


def test_binned_wrapper_rejects_bad_shapes_and_counts_no_cpu_launch():
    with pytest.raises(ValueError, match="expects"):
        binned_stat_scores(torch.rand(4, 3), torch.ones(4, 2), _linspace_thresholds(5))
    with pytest.raises(ValueError, match="expects"):
        binned_stat_scores(torch.rand(4), torch.ones(4), _linspace_thresholds(5))
    with pytest.raises(RuntimeError, match="same device"):
        binned_stat_scores(torch.rand(4, 3, device="meta"), torch.ones(4, 3, device="meta"), _linspace_thresholds(5))
    reset_launches()
    binned_stat_scores(torch.rand(8, 3), torch.ones(8, 3), _linspace_thresholds(5))
    assert launches()["binned_stats"] == 0


@pytest.mark.parametrize("num", [1, 2, 5, 11, 100, 1000])
def test_threshold_helper_gives_jnp_linspace_bits(num):
    ref = np.asarray(jnp.linspace(0, 1.0, num))
    got = _linspace_thresholds(num).numpy()
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


# ---------------------------------------------------------------- modules
def _data(kind, n, c, seed):
    """Seeded scores and int32 labels (the JAX package's dtype for integer inputs)."""
    rng = np.random.RandomState(seed)
    if kind == "binary":
        return rng.rand(n).astype(np.float32), rng.randint(0, 2, n).astype(np.int32)
    if kind == "multiclass":
        logits = rng.randn(n, c).astype(np.float32)
        probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        return probs.astype(np.float32), rng.randint(0, c, n).astype(np.int32)
    return rng.rand(n, c).astype(np.float32), rng.randint(0, 2, (n, c)).astype(np.int32)


def _batches(kind, c, seed, sizes=(64, 64, 37)):
    return [_data(kind, n, c, seed + i) for i, n in enumerate(sizes)]


def _assert_states(jm, tm):
    for name in jm._defaults:
        ref, got = getattr(jm, name), getattr(tm, name)
        if isinstance(ref, list):  # list states: equal entries in equal order
            assert isinstance(got, list) and len(got) == len(ref)
            if not ref:
                continue
            ref, got = jnp.concatenate(ref), torch.cat(got)
        _assert_same(ref, got, exact=True)


def _drive(jm, tm, batches, every_step=True):
    """Update (forward on the second batch), then compare states and values;
    the list-state metrics build their curves at the end only."""
    for i, (preds, target) in enumerate(batches):
        jp, jt, tp, tt = jnp.asarray(preds), jnp.asarray(target), _t(preds), _t(target)
        if i == 1:  # forward: the batch's value, and the batch accumulated once
            _assert_same(jm(jp, jt), tm(tp, tt), exact=False)
        else:
            jm.update(jp, jt)
            tm.update(tp, tt)
        _assert_states(jm, tm)
        if every_step or i == len(batches) - 1:
            _assert_same(jm.compute(), tm.compute(), exact=False)
    assert tm._update_count == len(batches) == jm._update_count
    tm.reset()
    jm.reset()
    assert tm._update_count == 0
    _assert_states(jm, tm)


_KINDS = [("binary", 1), ("multiclass", 5), ("multilabel", 4)]


@pytest.mark.parametrize("kind,c", _KINDS)
@pytest.mark.parametrize("metric", ["BinnedPrecisionRecallCurve", "BinnedAveragePrecision", "BinnedRecallAtFixedPrecision"])
@pytest.mark.parametrize("thresholds", [11, [0.1, 0.3, 0.5, 0.5, 0.9]])
def test_binned_modules(kind, c, metric, thresholds):
    kwargs = dict(num_classes=c, thresholds=thresholds)
    if metric == "BinnedRecallAtFixedPrecision":
        kwargs["min_precision"] = 0.4
    jm = getattr(metrics_tpu, metric)(**kwargs)
    tm = getattr(metrics_tpu_torch, metric)(device="cpu", **kwargs)
    _assert_same(jm.thresholds, tm.thresholds, exact=True)
    _drive(jm, tm, _batches(kind, c, seed=len(kind) + c))


def test_binned_thresholds_given_as_a_tensor():
    thr = np.array([0.2, 0.6, 0.4], np.float32)
    jm = metrics_tpu.BinnedAveragePrecision(num_classes=3, thresholds=jnp.asarray(thr))
    tm = metrics_tpu_torch.BinnedAveragePrecision(num_classes=3, thresholds=_t(thr).double(), device="cpu")
    assert tm.thresholds.dtype == torch.float32 and tm.num_thresholds == 3
    _drive(jm, tm, _batches("multilabel", 3, seed=41))


# micro AP on multiclass input is refused by both (test_same_constructor_and_input_errors)
_AP_CASES = [(k, c, a) for k, c in _KINDS for a in ("macro", "weighted", "micro", None) if (k, a) != ("multiclass", "micro")]


@pytest.mark.parametrize("kind,c,average", _AP_CASES)
def test_average_precision_module(kind, c, average):
    kwargs = dict(num_classes=c if kind != "binary" else None, average=average)
    jm = metrics_tpu.AveragePrecision(**kwargs)
    tm = metrics_tpu_torch.AveragePrecision(device="cpu", **kwargs)
    _drive(jm, tm, _batches(kind, c, seed=7 + c, sizes=(32, 32, 17)), every_step=False)


@pytest.mark.parametrize("kind,c", _KINDS)
def test_precision_recall_curve_module(kind, c):
    kwargs = dict(num_classes=c if kind != "binary" else None)
    jm = metrics_tpu.PrecisionRecallCurve(**kwargs)
    tm = metrics_tpu_torch.PrecisionRecallCurve(device="cpu", **kwargs)
    _drive(jm, tm, _batches(kind, c, seed=19 + c, sizes=(32, 32, 17)), every_step=False)


def _raises_alike(make_jax, make_torch):
    with pytest.raises(Exception) as jax_err:
        make_jax()
    with pytest.raises(Exception) as torch_err:
        make_torch()
    assert type(torch_err.value) is type(jax_err.value)
    assert str(torch_err.value) == str(jax_err.value)


@pytest.mark.parametrize(
    "case",
    ["thresholds string", "thresholds float", "AP average", "AP micro multiclass", "curve num_classes mismatch",
     "curve ndim", "curve compute without classes"],
)
def test_same_constructor_and_input_errors(case):
    preds, target = _data("multiclass", 8, 3, seed=1)
    if case == "thresholds string":
        _raises_alike(lambda: metrics_tpu.BinnedAveragePrecision(num_classes=2, thresholds="10"),
                      lambda: metrics_tpu_torch.BinnedAveragePrecision(num_classes=2, thresholds="10", device="cpu"))
    elif case == "thresholds float":
        _raises_alike(lambda: metrics_tpu.BinnedPrecisionRecallCurve(num_classes=2, thresholds=0.5),
                      lambda: metrics_tpu_torch.BinnedPrecisionRecallCurve(num_classes=2, thresholds=0.5, device="cpu"))
    elif case == "AP average":
        _raises_alike(lambda: metrics_tpu.AveragePrecision(average="samples"),
                      lambda: metrics_tpu_torch.AveragePrecision(average="samples", device="cpu"))
    elif case == "AP micro multiclass":
        _raises_alike(lambda: metrics_tpu.AveragePrecision(num_classes=3, average="micro").update(
                          jnp.asarray(preds), jnp.asarray(target)),
                      lambda: metrics_tpu_torch.AveragePrecision(num_classes=3, average="micro", device="cpu").update(
                          _t(preds), _t(target)))
    elif case == "curve num_classes mismatch":
        _raises_alike(lambda: jF.precision_recall_curve(jnp.asarray(preds), jnp.asarray(target), num_classes=4),
                      lambda: tF.precision_recall_curve(_t(preds), _t(target), num_classes=4))
    elif case == "curve ndim":
        _raises_alike(lambda: jF.precision_recall_curve(jnp.asarray(preds[:, :, None]), jnp.asarray(target)),
                      lambda: tF.precision_recall_curve(_t(preds[:, :, None]), _t(target)))
    else:
        def compute(pkg, prep, dev):
            m = pkg.PrecisionRecallCurve(**dev)
            m.update(prep(preds[:, 0]), prep(target))
            m.num_classes = 0
            m.compute()
        _raises_alike(lambda: compute(metrics_tpu, jnp.asarray, {}), lambda: compute(metrics_tpu_torch, _t, {"device": "cpu"}))


def test_nan_scores_count_as_positives_missed():
    preds = np.array([0.9, np.nan, 0.2, np.nan], np.float32)
    target = np.array([1, 1, 0, 0])
    jm = metrics_tpu.BinnedPrecisionRecallCurve(num_classes=1, thresholds=5)
    tm = metrics_tpu_torch.BinnedPrecisionRecallCurve(num_classes=1, thresholds=5, device="cpu")
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    tm.update(_t(preds), _t(target))
    _assert_states(jm, tm)
    assert tm.FNs[0, 0].item() == 1.0 and tm.TPs[0, 0].item() == 1.0 and tm.FPs[0, 0].item() == 1.0


def test_to_moves_the_thresholds():
    tm = metrics_tpu_torch.BinnedAveragePrecision(num_classes=3, thresholds=7, device="cpu")
    np.testing.assert_array_equal(tm.thresholds.numpy(), np.asarray(jnp.linspace(0, 1, 7)))
    tm.to("meta")
    assert tm.device.type == "meta"
    assert tm.thresholds.device.type == "meta" and tm.TPs.device.type == "meta"


def test_binned_pure_update_leaves_the_given_state_alone():
    tm = metrics_tpu_torch.BinnedAveragePrecision(num_classes=3, thresholds=9, device="cpu")
    preds, target = _data("multiclass", 32, 3, seed=2)
    state = tm.default_state()
    new = tm.pure_update(state, _t(preds), _t(target))
    assert all(int(v.abs().sum()) == 0 for v in state.values())
    assert int(new["TPs"].sum()) > 0 and int(tm.TPs.sum()) == 0


# ------------------------------------------------------------- functional
@pytest.mark.parametrize("kind,c,average", _AP_CASES)
def test_functional_average_precision(kind, c, average):
    preds, target = _data(kind, 120, c, seed=3 + c)
    kwargs = dict(num_classes=c if kind != "binary" else None, average=average)
    if kind == "binary":
        kwargs["pos_label"] = 1
    _assert_same(
        jF.average_precision(jnp.asarray(preds), jnp.asarray(target), **kwargs),
        tF.average_precision(_t(preds), _t(target), **kwargs),
        exact=False,
    )


@pytest.mark.parametrize("kind,c", _KINDS)
def test_functional_precision_recall_curve(kind, c):
    preds, target = _data(kind, 120, c, seed=5 + c)
    preds = np.round(preds * 20) / 20  # ties: runs of equal scores
    kwargs = dict(num_classes=c if kind != "binary" else None)
    _assert_same(
        jF.precision_recall_curve(jnp.asarray(preds), jnp.asarray(target), **kwargs),
        tF.precision_recall_curve(_t(preds), _t(target), **kwargs),
        exact=True,
    )


def test_functional_precision_recall_curve_sample_weights_and_nan_class():
    preds, target = _data("binary", 60, 1, seed=9)
    weights = np.random.RandomState(9).rand(60).astype(np.float32)
    _assert_same(
        jF.precision_recall_curve(jnp.asarray(preds), jnp.asarray(target), pos_label=1, sample_weights=list(weights)),
        tF.precision_recall_curve(_t(preds), _t(target), pos_label=1, sample_weights=list(weights)),
        exact=False,
    )
    # class 2 never occurs: its AP is NaN, left out of the macro average with a warning
    preds, target = _data("multiclass", 50, 3, seed=10)
    target = target % 2
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        ref = jF.average_precision(jnp.asarray(preds), jnp.asarray(target), num_classes=3)
        got = tF.average_precision(_t(preds), _t(target), num_classes=3)
    assert sum("was `nan`" in str(w.message) for w in seen) == 2
    _assert_same(ref, got, exact=False)


# ------------------------------------------------------------- checkpoints
def test_binned_state_dict_jax_to_port_to_jax():
    batches = _batches("multiclass", 5, seed=29)
    kwargs = dict(num_classes=5, thresholds=13)
    jm = metrics_tpu.BinnedAveragePrecision(**kwargs)
    jm.persistent(True)
    for preds, target in batches[:2]:
        jm.update(jnp.asarray(preds), jnp.asarray(target))
    payload = jm.state_dict()

    tm = metrics_tpu_torch.BinnedAveragePrecision(device="cpu", **kwargs)
    tm.persistent(True)
    load_jax_state_dict(tm, payload)
    _assert_states(jm, tm)
    _assert_same(jm.compute(), tm.compute(), exact=False)

    preds, target = batches[2]
    tm.update(_t(preds), _t(target))
    back = to_jax_state_dict(tm)
    jm2 = metrics_tpu.BinnedAveragePrecision(**kwargs)
    jm2.persistent(True)
    jm2.load_state_dict(back)  # verifies the port's checksums
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    _assert_states(jm2, tm)
    _assert_same(jm2.compute(), tm.compute(), exact=False)
    assert {k: v for k, v in jm.state_dict().items() if k.startswith("__checksum__")} == {
        k: v for k, v in tm.state_dict().items() if k.startswith("__checksum__")
    }
