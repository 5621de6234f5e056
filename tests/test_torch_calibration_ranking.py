"""The port's CalibrationError, HingeLoss, KLDivergence, the multilabel
ranking trio and ``dice_score`` held against the JAX package on the CPU.

The same seeded numpy inputs go through ``metrics_tpu`` and
``metrics_tpu_torch``. Tolerances:

* bit-equal: CalibrationError's bin boundaries (``jnp.linspace``'s float32
  bits, for every ``n_bins`` from 1 to 100) and its bins (each bin's share of
  the samples, a float32 division of equal counts); the ranking trio's
  summed coverage counts and the ranking loss's inverse ranks; dice's per-class
  true positives, false positives and false negatives;
* rtol 1e-5: CalibrationError (per-bin float sums), KLDivergence (``log``);
* rtol 1e-6: HingeLoss, label ranking average precision, label ranking loss
  and dice values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu.functional as jF
import metrics_tpu_torch
import metrics_tpu_torch.functional as tF
from metrics_tpu.functional.classification.calibration_error import _binning_bucketize as jax_bucketize
from metrics_tpu.functional.classification.calibration_error import _ce_compute as jax_ce_compute
from metrics_tpu.functional.classification.calibration_error import _ce_update as jax_ce_update
from metrics_tpu.functional.classification.ranking import _coverage_error_update as jax_coverage_update
from metrics_tpu_torch.functional.classification.calibration_error import (
    _bin_boundaries,
    _binning_bucketize,
    _ce_compute,
    _ce_update,
)
from metrics_tpu_torch.functional.classification.dice import _dice_counts
from metrics_tpu_torch.functional.classification.ranking import _coverage_error_update

CE_RTOL = 1e-5
KL_RTOL = 1e-5
RTOL = 1e-6


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert(ref, got, rtol=None):
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


def _softmax(rng, n, c, scale=2.0):
    logits = scale * rng.randn(n, c).astype(np.float32)
    e = np.exp(logits - logits.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


# -------------------------------------------------------- CalibrationError
def test_bin_boundaries_bit_equal_to_jnp_linspace_for_every_n_bins_up_to_100():
    differs_from_torch = []
    for n_bins in range(1, 101):
        ref = np.asarray(jnp.linspace(0, 1, n_bins + 1, dtype=jnp.float32))
        got = _bin_boundaries(n_bins)
        _assert(ref, got)
        if not torch.equal(torch.linspace(0, 1, n_bins + 1, dtype=torch.float32), got):
            differs_from_torch.append(n_bins)
    # why the boundaries are built by hand: torch.linspace's float32 bits differ, the default 15 among them
    assert 15 in differs_from_torch and 10 in differs_from_torch and differs_from_torch[0] == 3


@pytest.mark.parametrize("n_bins", [3, 10, 15, 64])
def test_bins_of_confidences_on_and_between_boundaries_bit_equal_to_jax(n_bins):
    rng = np.random.RandomState(n_bins)
    bounds = np.asarray(jnp.linspace(0, 1, n_bins + 1, dtype=jnp.float32))
    conf = np.concatenate([bounds, np.nextafter(bounds, np.float32(2)), np.nextafter(bounds, np.float32(-1)),
                           rng.rand(200).astype(np.float32)]).astype(np.float32)
    conf = np.clip(conf, 0, 1)
    acc = (rng.rand(conf.size) < 0.6).astype(np.float32)
    ref = jax_bucketize(jnp.asarray(conf), jnp.asarray(acc), jnp.asarray(bounds))
    got = _binning_bucketize(_t(conf), _t(acc), _bin_boundaries(n_bins))
    _assert(ref[2], got[2])  # each bin's share of the samples: the bin indices, counted
    _assert(ref[0], got[0], CE_RTOL)
    _assert(ref[1], got[1], CE_RTOL)


@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
@pytest.mark.parametrize("mode", ["binary", "multiclass", "multidim multiclass"])
@pytest.mark.parametrize("n_bins", [1, 10, 15])
def test_calibration_error_functional_equal_to_jax(norm, mode, n_bins):
    rng = np.random.RandomState(7)
    if mode == "binary":
        preds, target = rng.rand(300).astype(np.float32), rng.randint(0, 2, 300)
    elif mode == "multiclass":
        preds, target = _softmax(rng, 300, 6), rng.randint(0, 6, 300)
    else:
        preds = _softmax(rng, 120, 6).reshape(20, 6, 6).transpose(0, 2, 1).copy()
        target = rng.randint(0, 6, (20, 6))
    ref = jF.calibration_error(jnp.asarray(preds), jnp.asarray(target), n_bins=n_bins, norm=norm)
    got = tF.calibration_error(_t(preds), _t(target), n_bins=n_bins, norm=norm)
    _assert(ref, got, CE_RTOL)


@pytest.mark.parametrize("debias", [False, True])
def test_l2_calibration_error_with_debias_equal_to_jax(debias):
    rng = np.random.RandomState(8)
    preds, target = _softmax(rng, 250, 5, scale=1.0), rng.randint(0, 5, 250)
    jc, ja = jax_ce_update(jnp.asarray(preds), jnp.asarray(target))
    tc, ta = _ce_update(_t(preds), _t(target))
    _assert(jc, tc)
    _assert(ja, ta)
    for n_bins in (4, 15):
        bounds = jnp.linspace(0, 1, n_bins + 1, dtype=jnp.float32)
        ref = jax_ce_compute(jc, ja, bounds, norm="l2", debias=debias)
        _assert(ref, _ce_compute(tc, ta, _bin_boundaries(n_bins), norm="l2", debias=debias), CE_RTOL)


@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
def test_calibration_error_module_over_batches_equal_to_jax(norm):
    rng = np.random.RandomState(9)
    jm, tm = metrics_tpu.CalibrationError(norm=norm), metrics_tpu_torch.CalibrationError(norm=norm, device="cpu")
    assert tm._device_attributes == ("bin_boundaries",)
    _assert(jm.bin_boundaries, tm.bin_boundaries)
    for n in (100, 1, 150):
        preds, target = _softmax(rng, n, 4), rng.randint(0, 4, n)
        _assert(jm(jnp.asarray(preds), jnp.asarray(target)), tm(_t(preds), _t(target)), CE_RTOL)
    _assert(jm.compute(), tm.compute(), CE_RTOL)
    tm.to("cpu")
    assert tm.bin_boundaries.device.type == "cpu"


@pytest.mark.parametrize("case", ["norm", "n_bins zero", "n_bins float", "multilabel"])
def test_calibration_error_errors_like_jax(case):
    rng = np.random.RandomState(10)
    preds, target = _softmax(rng, 20, 3), rng.randint(0, 3, 20)
    kwargs = {"norm": dict(norm="l3"), "n_bins zero": dict(n_bins=0), "n_bins float": dict(n_bins=2.0),
              "multilabel": dict()}[case]
    if case == "multilabel":
        preds, target = rng.rand(20, 3).astype(np.float32), rng.randint(0, 2, (20, 3))
    else:
        _same_error(lambda: metrics_tpu.CalibrationError(**kwargs),
                    lambda: metrics_tpu_torch.CalibrationError(device="cpu", **kwargs))
    _same_error(lambda: jF.calibration_error(jnp.asarray(preds), jnp.asarray(target), **kwargs),
                lambda: tF.calibration_error(_t(preds), _t(target), **kwargs))


# ------------------------------------------------------------- HingeLoss
def _hinge_inputs(mode, seed):
    rng = np.random.RandomState(seed)
    if mode == "binary":
        return (2 * rng.randn(300)).astype(np.float32), rng.randint(0, 2, 300)
    return (2 * rng.randn(300, 5)).astype(np.float32), rng.randint(0, 5, 300)


@pytest.mark.parametrize("mode,multiclass_mode", [("binary", None), ("multiclass", None),
                                                  ("multiclass", "crammer-singer"), ("multiclass", "one-vs-all")])
@pytest.mark.parametrize("squared", [False, True])
def test_hinge_loss_functional_and_module_equal_to_jax(mode, multiclass_mode, squared):
    preds, target = _hinge_inputs(mode, 11)
    ref = jF.hinge_loss(jnp.asarray(preds), jnp.asarray(target), squared=squared, multiclass_mode=multiclass_mode)
    got = tF.hinge_loss(_t(preds), _t(target), squared=squared, multiclass_mode=multiclass_mode)
    _assert(ref, got, RTOL)
    jm = metrics_tpu.HingeLoss(squared=squared, multiclass_mode=multiclass_mode)
    tm = metrics_tpu_torch.HingeLoss(squared=squared, multiclass_mode=multiclass_mode, device="cpu")
    for sl in (slice(0, 100), slice(100, 300)):
        _assert(jm(jnp.asarray(preds[sl]), jnp.asarray(target[sl])), tm(_t(preds[sl]), _t(target[sl])), RTOL)
    _assert(jm.total, tm.total)
    _assert(jm.compute(), tm.compute(), RTOL)


def test_hinge_multiclass_mode_enum_and_errors_like_jax():
    from metrics_tpu.functional.classification.hinge import MulticlassMode as JaxMode
    from metrics_tpu_torch.functional.classification.hinge import MulticlassMode

    assert [m.value for m in MulticlassMode] == [m.value for m in JaxMode]
    assert MulticlassMode.from_str("One-Vs-All") is MulticlassMode.ONE_VS_ALL
    preds, target = _hinge_inputs("multiclass", 12)
    ref = jF.hinge_loss(jnp.asarray(preds), jnp.asarray(target), multiclass_mode=JaxMode.ONE_VS_ALL)
    _assert(ref, tF.hinge_loss(_t(preds), _t(target), multiclass_mode=MulticlassMode.ONE_VS_ALL), RTOL)
    _same_error(lambda: metrics_tpu.HingeLoss(multiclass_mode="svm"),
                lambda: metrics_tpu_torch.HingeLoss(multiclass_mode="svm", device="cpu"))
    for p, t, kw in ((preds, target, dict(multiclass_mode="svm")),
                     (preds[:, 0], target[:10], {}),
                     (preds[:10], target[:9], {}),
                     (preds.reshape(60, 5, 5), target[:60], {}),
                     (preds[:, 0], np.stack([target, target], 1), {})):
        _same_error(lambda: jF.hinge_loss(jnp.asarray(p), jnp.asarray(t), **kw),
                    lambda: tF.hinge_loss(_t(p), _t(t), **kw))


# ---------------------------------------------------------- KLDivergence
@pytest.mark.parametrize("log_prob", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none", None])
def test_kl_divergence_functional_and_module_equal_to_jax(log_prob, reduction):
    rng = np.random.RandomState(13)
    p, q = _softmax(rng, 120, 6), _softmax(rng, 120, 6)
    if log_prob:
        p, q = np.log(p), np.log(q)
    ref = jF.kl_divergence(jnp.asarray(p), jnp.asarray(q), log_prob=log_prob, reduction=reduction)
    _assert(ref, tF.kl_divergence(_t(p), _t(q), log_prob=log_prob, reduction=reduction), KL_RTOL)
    jm = metrics_tpu.KLDivergence(log_prob=log_prob, reduction=reduction)
    tm = metrics_tpu_torch.KLDivergence(log_prob=log_prob, reduction=reduction, device="cpu")
    assert isinstance(tm.measures, list) == isinstance(jm.measures, list) == (reduction in ("none", None))
    for sl in (slice(0, 50), slice(50, 120)):
        _assert(jm(jnp.asarray(p[sl]), jnp.asarray(q[sl])), tm(_t(p[sl]), _t(q[sl])), KL_RTOL)
    _assert(jm.total, tm.total)
    _assert(jm.compute(), tm.compute(), KL_RTOL)


def test_kl_divergence_errors_like_jax():
    p = np.random.RandomState(14).rand(4, 3).astype(np.float32)
    _same_error(lambda: metrics_tpu.KLDivergence(log_prob=1), lambda: metrics_tpu_torch.KLDivergence(log_prob=1, device="cpu"))
    _same_error(lambda: metrics_tpu.KLDivergence(reduction="max"),
                lambda: metrics_tpu_torch.KLDivergence(reduction="max", device="cpu"))
    for a, b in ((p, p[:3]), (p[0], p[0])):
        _same_error(lambda: jF.kl_divergence(jnp.asarray(a), jnp.asarray(b)), lambda: tF.kl_divergence(_t(a), _t(b)))


# ------------------------------------------------------ the ranking trio
def _ranking_inputs(seed, n=200, c=8, grid=4):
    """Scores on a coarse grid (ties within a row), with rows where no label
    and where every label is relevant."""
    rng = np.random.RandomState(seed)
    preds = (np.round(rng.rand(n, c) * grid) / grid).astype(np.float32)
    target = (rng.rand(n, c) < 0.3).astype(np.int64)
    target[0] = 0
    target[1] = 1
    return preds, target, rng.rand(n).astype(np.float32)


def test_ranking_loss_inverse_ranks_bit_equal_to_jax_on_ties():
    preds, _, _ = _ranking_inputs(15, grid=2)
    ref = jnp.argsort(jnp.argsort(jnp.asarray(preds), axis=1), axis=1)
    got = torch.argsort(torch.argsort(_t(preds), dim=1, stable=True), dim=1, stable=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("weighted", [False, True])
def test_coverage_counts_bit_equal_to_jax(weighted):
    preds, target, w = _ranking_inputs(16)
    ref = jax_coverage_update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(w) if weighted else None)
    got = _coverage_error_update(_t(preds), _t(target), _t(w) if weighted else None)
    _assert(ref[0], got[0], RTOL if weighted else None)
    assert ref[1] == got[1]


@pytest.mark.parametrize("name,module", [("coverage_error", "CoverageError"),
                                         ("label_ranking_average_precision", "LabelRankingAveragePrecision"),
                                         ("label_ranking_loss", "LabelRankingLoss")])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("grid", [4, 1000])
def test_ranking_trio_functional_and_module_equal_to_jax(name, module, weighted, grid):
    preds, target, w = _ranking_inputs(17, grid=grid)
    kw_j = dict(sample_weight=jnp.asarray(w)) if weighted else {}
    kw_t = dict(sample_weight=_t(w)) if weighted else {}
    _assert(getattr(jF, name)(jnp.asarray(preds), jnp.asarray(target), **kw_j),
            getattr(tF, name)(_t(preds), _t(target), **kw_t), RTOL)
    jm, tm = getattr(metrics_tpu, module)(), getattr(metrics_tpu_torch, module)(device="cpu")
    for sl in (slice(0, 60), slice(60, 200)):
        kj = dict(sample_weight=jnp.asarray(w[sl])) if weighted else {}
        kt = dict(sample_weight=_t(w[sl])) if weighted else {}
        _assert(jm(jnp.asarray(preds[sl]), jnp.asarray(target[sl]), **kj), tm(_t(preds[sl]), _t(target[sl]), **kt), RTOL)
    _assert(jm.compute(), tm.compute(), RTOL)


@pytest.mark.parametrize("name", ["coverage_error", "label_ranking_average_precision", "label_ranking_loss"])
def test_ranking_trio_errors_like_jax(name):
    preds, target, w = _ranking_inputs(18, n=10)
    for p, t, sw in ((preds[0], target[0], None), (preds, target[:, :4], None), (preds, target, w[:5])):
        _same_error(lambda: getattr(jF, name)(jnp.asarray(p), jnp.asarray(t), None if sw is None else jnp.asarray(sw)),
                    lambda: getattr(tF, name)(_t(p), _t(t), None if sw is None else _t(sw)))


# ------------------------------------------------------------------ dice
@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
@pytest.mark.parametrize("inputs", ["scores", "label maps"])
def test_dice_score_equal_to_jax(bg, reduction, inputs):
    rng = np.random.RandomState(19)
    c = 6
    if inputs == "scores":
        preds = _softmax(rng, 300, c)
        target = rng.randint(0, c - 1, 300)  # the last class never occurs in the target: no_fg_score
        preds_lbl = preds.argmax(1)
    else:
        # labels of the target's shape: dice_score takes the class count from their second dim, as the JAX package
        preds = rng.randint(0, c, (50, c))
        target = np.where(rng.rand(50, c) < 0.7, preds, rng.randint(0, c - 1, (50, c)))
        target[target == c - 1] = 0
        preds_lbl = preds
    for nan_score, no_fg_score in ((0.0, 0.0), (0.5, 0.25)):
        kw = dict(bg=bg, nan_score=nan_score, no_fg_score=no_fg_score, reduction=reduction)
        _assert(jF.dice_score(jnp.asarray(preds), jnp.asarray(target), **kw), tF.dice_score(_t(preds), _t(target), **kw),
                RTOL)
    tp, fp, fn, has_fg = _dice_counts(_t(preds), _t(target), bg)
    classes = np.arange(0 if bg else 1, c)
    lbl, tgt = preds_lbl.reshape(-1), target.reshape(-1)
    for got, want in ((tp, [((lbl == k) & (tgt == k)).sum() for k in classes]),
                      (fp, [((lbl == k) & (tgt != k)).sum() for k in classes]),
                      (fn, [((lbl != k) & (tgt == k)).sum() for k in classes])):
        _assert(np.array(want, np.float32), got)
    np.testing.assert_array_equal(has_fg.numpy(), np.isin(classes, tgt))
