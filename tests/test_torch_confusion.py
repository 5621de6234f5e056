"""The confusion-matrix family of the port held against the JAX package on the CPU.

CohenKappa, MatthewsCorrCoef and JaccardIndex, functional and module form,
and ``reduce``/``class_reduce``: the same seeded numpy inputs go through
``metrics_tpu`` and ``metrics_tpu_torch``. Confusion-matrix states and any
integer output must be exactly equal and of equal dtype. Float values must
agree to ``rtol=1e-6``: both are float32, but XLA and PyTorch sum the cells
in another order, which moves the last bit or so. Cohen's kappa is ``1 - k``
with ``k`` near 1 when the labellings barely agree, so its absolute error is
that of ``k``: kappa values are also allowed ``atol=2**-23``, one float32
step at 1.0 (``KAPPA_ATOL``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu.functional as jF
import metrics_tpu_torch
import metrics_tpu_torch.functional as tF
from metrics_tpu.utilities.distributed import class_reduce as jax_class_reduce
from metrics_tpu.utilities.distributed import reduce as jax_reduce
from metrics_tpu_torch.interop import load_jax_state_dict, to_jax_state_dict
from metrics_tpu_torch.utilities.distributed import class_reduce, reduce

RTOL = 1e-6
KAPPA_ATOL = 2.0**-23
C = 7
ABSENT = 5  # a class that no label and no prediction names in the "absent" inputs
KINDS = ["scores", "labels", "nan_scores", "segmentation"]


def _pair(x):
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def _assert_same(jax_out, torch_out, exact, atol=0.0):
    ref = np.asarray(jax_out)
    got = torch_out.numpy()
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert got.shape == ref.shape
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=atol)


def _inputs(kind, n=96, c=C, seed=0, absent=False):
    """``(preds, target)`` of one kind: class scores, class labels, scores with
    NaN rows, or ``(N, H, W)`` label maps (segmentation); with ``absent``, class
    ``ABSENT`` appears in neither."""
    rng = np.random.RandomState(seed)
    if kind == "segmentation":
        # label maps in runs of 4 pixels, predictions right on about 80% of pixels
        target = np.repeat(rng.randint(0, c, (n // 24, 4, 2)), 4, axis=2)
        preds = np.where(rng.rand(*target.shape) < 0.8, target, rng.randint(0, c, target.shape))
        if absent:
            target[target == ABSENT], preds[preds == ABSENT] = ABSENT - 1, ABSENT - 1
        return preds, target
    probs, labels = rng.rand(n, c).astype(np.float32), rng.randint(0, c, n)
    if absent:
        labels[labels == ABSENT] = ABSENT - 1
        probs[:, ABSENT] = 0.0
    hit = rng.rand(n) < 0.6  # the label on top for about 60% of rows
    probs[hit, labels[hit]] = 1.0
    if kind == "nan_scores":  # every 7th row holds a NaN
        probs[::7, seed % c] = np.nan
    if kind == "labels":
        return probs.argmax(1), labels
    return probs, labels


# ------------------------------------------------------------- functional
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("weights", [None, "none", "linear", "quadratic"])
def test_functional_cohen_kappa(kind, weights):
    preds, target = _inputs(kind, seed=1)
    (jp, tp), (jt, tt) = _pair(preds), _pair(target)
    kwargs = dict(num_classes=C, weights=weights)
    _assert_same(jF.cohen_kappa(jp, jt, **kwargs), tF.cohen_kappa(tp, tt, **kwargs), exact=False, atol=KAPPA_ATOL)


@pytest.mark.parametrize("kind", KINDS)
def test_functional_matthews_corrcoef(kind):
    preds, target = _inputs(kind, seed=2)
    (jp, tp), (jt, tt) = _pair(preds), _pair(target)
    _assert_same(jF.matthews_corrcoef(jp, jt, num_classes=C), tF.matthews_corrcoef(tp, tt, num_classes=C), exact=False)


@pytest.mark.parametrize("labels", [[0, 0, 0, 0], [2, 2, 2, 2]])
def test_functional_matthews_corrcoef_one_class_only(labels):
    # every marginal constant: the denominator is 0 and both packages give 0
    (jl, tl) = _pair(np.asarray(labels))
    got = tF.matthews_corrcoef(tl, tl, num_classes=3)
    _assert_same(jF.matthews_corrcoef(jl, jl, num_classes=3), got, exact=True)
    assert float(got) == 0.0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ignore_index", [None, 0, C - 1, C + 3])
@pytest.mark.parametrize("absent_score", [0.0, 1.0])
@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_functional_jaccard_index(kind, ignore_index, absent_score, reduction):
    preds, target = _inputs(kind, seed=3, absent=True)
    (jp, tp), (jt, tt) = _pair(preds), _pair(target)
    kwargs = dict(num_classes=C, ignore_index=ignore_index, absent_score=absent_score, reduction=reduction)
    got = tF.jaccard_index(tp, tt, **kwargs)
    _assert_same(jF.jaccard_index(jp, jt, **kwargs), got, exact=False)
    if reduction == "none":  # one score a class, less the ignored one; the absent class scores absent_score
        kept = [k for k in range(C) if k != ignore_index]
        assert got.shape == (len(kept),) and float(got[kept.index(ABSENT)]) == absent_score


def test_functional_cohen_kappa_refuses_unknown_weights():
    (jp, tp), (jt, tt) = _pair(np.asarray([0, 1, 1])), _pair(np.asarray([0, 1, 0]))
    with pytest.raises(ValueError) as jax_err:
        jF.cohen_kappa(jp, jt, num_classes=2, weights="cubic")
    with pytest.raises(ValueError) as torch_err:
        tF.cohen_kappa(tp, tt, num_classes=2, weights="cubic")
    assert str(torch_err.value) == str(jax_err.value)


# ------------------------------------------------------ reduce helpers
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.bool_])
@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none", None])
def test_reduce(dtype, reduction):
    x = (np.random.RandomState(4).rand(11) * 5).astype(dtype)
    jx, tx = _pair(x)
    _assert_same(jax_reduce(jx, reduction), reduce(tx, reduction), exact=dtype is not np.float32)


@pytest.mark.parametrize("class_reduction", ["micro", "macro", "weighted", "none", None])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_class_reduce(class_reduction, dtype):
    rng = np.random.RandomState(5)
    num = rng.randint(0, 5, 9).astype(dtype)
    denom = (num + rng.randint(0, 3, 9)).astype(dtype)
    num[2], denom[2] = 0, 0  # 0/0 counts as 0
    weights = rng.randint(0, 9, 9).astype(dtype)
    (jn, tn), (jd, td), (jw, tw) = _pair(num), _pair(denom), _pair(weights)
    got = class_reduce(tn, td, tw, class_reduction)
    _assert_same(jax_class_reduce(jn, jd, jw, class_reduction), got, exact=False)
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("fn,args", [(reduce, ("max",)), (class_reduce, (np.ones(3), np.ones(3), "median"))])
def test_reduce_helpers_refuse_unknown_reductions(fn, args):
    jax_fn = jax_reduce if fn is reduce else jax_class_reduce
    x = np.ones(3, np.float32)
    with pytest.raises(ValueError) as jax_err:
        jax_fn(jnp.asarray(x), *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
    with pytest.raises(ValueError) as torch_err:
        fn(torch.from_numpy(x), *(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args))
    assert str(torch_err.value) == str(jax_err.value)


# ---------------------------------------------------------------- modules
MODULES = {
    "kappa": ("CohenKappa", dict(num_classes=C)),
    "kappa_linear": ("CohenKappa", dict(num_classes=C, weights="linear")),
    "kappa_quadratic": ("CohenKappa", dict(num_classes=C, weights="quadratic")),
    "mcc": ("MatthewsCorrCoef", dict(num_classes=C)),
    "jaccard": ("JaccardIndex", dict(num_classes=C)),
    "jaccard_ignore": ("JaccardIndex", dict(num_classes=C, ignore_index=0, absent_score=1.0, reduction="none")),
}


def _assert_states(jm, tm):
    for name in jm._defaults:
        _assert_same(getattr(jm, name), getattr(tm, name), exact=True)


@pytest.mark.parametrize("update_method", ["bincount", "matmul"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("module", sorted(MODULES))
def test_module_updates_and_forward(module, kind, update_method):
    cls, kwargs = MODULES[module]
    kwargs = dict(kwargs, update_method=update_method)
    jm, tm = getattr(metrics_tpu, cls)(**kwargs), getattr(metrics_tpu_torch, cls)(device="cpu", **kwargs)
    for i in range(3):
        preds, target = _inputs(kind, n=64 if i < 2 else 40, seed=10 + i, absent=module.startswith("jaccard"))
        (jp, tp), (jt, tt) = _pair(preds), _pair(target)
        if i == 1:  # forward: the batch's value, and the batch accumulated once
            _assert_same(jm(jp, jt), tm(tp, tt), exact=False)
        else:
            jm.update(jp, jt)
            tm.update(tp, tt)
        _assert_states(jm, tm)
        assert tm.confmat.dtype == torch.int32
        _assert_same(jm.compute(), tm.compute(), exact=False)
    assert tm._update_count == 3 == jm._update_count
    tm.reset()
    assert int(tm.confmat.sum()) == 0 and tm._update_count == 0


@pytest.mark.parametrize("module", sorted(MODULES))
def test_module_update_methods_agree(module):
    cls, kwargs = MODULES[module]
    a, b = (getattr(metrics_tpu_torch, cls)(device="cpu", update_method=m, **kwargs) for m in ("bincount", "matmul"))
    for seed in range(3):
        preds, target = (torch.from_numpy(x) for x in _inputs("segmentation", seed=seed))
        a.update(preds, target)
        b.update(preds, target)
    assert torch.equal(a.confmat, b.confmat) and torch.equal(a.compute(), b.compute())


@pytest.mark.parametrize(
    "cls,kwargs",
    [("CohenKappa", dict(weights="cubic")), ("CohenKappa", dict(update_method="scatter")),
     ("MatthewsCorrCoef", dict(update_method="scatter")), ("JaccardIndex", dict(update_method="scatter"))],
)
def test_modules_refuse_bad_arguments_like_jax(cls, kwargs):
    with pytest.raises(ValueError) as jax_err:
        getattr(metrics_tpu, cls)(num_classes=3, **kwargs)
    with pytest.raises(ValueError) as torch_err:
        getattr(metrics_tpu_torch, cls)(num_classes=3, device="cpu", **kwargs)
    assert str(torch_err.value) == str(jax_err.value)


# ------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("module", ["kappa_quadratic", "mcc", "jaccard_ignore"])
def test_state_dict_jax_to_port_to_jax(module):
    cls, kwargs = MODULES[module]
    kwargs = dict(kwargs, update_method="matmul")
    batches = [_inputs("scores", n=64, seed=20 + i) for i in range(3)]
    jm = getattr(metrics_tpu, cls)(**kwargs)
    jm.persistent(True)
    for preds, target in batches[:2]:
        jm.update(jnp.asarray(preds), jnp.asarray(target))

    tm = getattr(metrics_tpu_torch, cls)(device="cpu", **kwargs)
    tm.persistent(True)
    load_jax_state_dict(tm, jm.state_dict())
    _assert_states(jm, tm)
    _assert_same(jm.compute(), tm.compute(), exact=False)

    preds, target = batches[2]
    tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    back = getattr(metrics_tpu, cls)(**kwargs)
    back.persistent(True)
    back.load_state_dict(to_jax_state_dict(tm))  # verifies the port's checksums
    _assert_states(back, tm)
    _assert_same(back.compute(), tm.compute(), exact=False)
    _assert_same(jm.compute(), tm.compute(), exact=False)
