"""The port's precision, recall, F-beta, specificity and Hamming distance
held against the JAX package on the CPU.

The same seeded numpy inputs go through ``metrics_tpu`` and
``metrics_tpu_torch``, functional and module form. States (tp/fp/tn/fn,
Hamming's correct/total) must be exactly equal and of equal dtype. Float
values must agree to ``rtol=1e-6``: both are float32, but XLA and PyTorch
sum the per-class scores in another order, which moves the last bit or so.
Where the JAX package refuses an input, the port must refuse it with the
same exception type and message.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu.functional as jF
import metrics_tpu_torch
import metrics_tpu_torch.functional as tF
from metrics_tpu_torch.interop import load_jax_state_dict, to_jax_state_dict

RTOL = 1e-6
C = 7

FUNCTIONALS = {
    "precision": {},
    "recall": {},
    "fbeta_score": {"beta": 0.5},
    "f1_score": {},
    "specificity": {},
}
MODULES = {
    "Precision": {},
    "Recall": {},
    "FBetaScore": {"beta": 0.5},
    "F1Score": {},
    "Specificity": {},
}


def _pair(x):
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def _assert_same(jax_out, torch_out, exact):
    if isinstance(jax_out, tuple):
        assert isinstance(torch_out, tuple) and len(torch_out) == len(jax_out)
        for j, t in zip(jax_out, torch_out):
            _assert_same(j, t, exact)
        return
    ref = np.asarray(jax_out)
    got = torch_out.numpy()
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert got.shape == ref.shape
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)


def _same_or_same_error(jax_call, torch_call, exact=False):
    """Both calls give the same values, or both raise the same error."""
    try:
        ref = jax_call()
    except Exception as jax_err:  # the port must refuse the input the same way
        with pytest.raises(type(jax_err)) as torch_err:
            torch_call()
        assert str(torch_err.value) == str(jax_err)
        return None
    got = torch_call()
    _assert_same(ref, got, exact)
    return got


def _inputs(kind, n=96, c=C, seed=0):
    rng = np.random.RandomState(seed)
    probs, labels = rng.rand(n, c).astype(np.float32), rng.randint(0, c, n)
    if kind == "scores":
        return probs, labels
    if kind == "nan_scores":  # every 7th row holds a NaN: its predicted class is C
        probs[::7, seed % c] = np.nan
        return probs, labels
    if kind == "labels":
        return probs.argmax(1), labels
    raise ValueError(kind)


def _num_classes(ignore_index, average):
    """C, except for a negative ``ignore_index`` under the averages that need
    no class count: with C, both packages refuse it (held as such too)."""
    return None if ignore_index == -1 and average in ("micro", "samples") else C


def _with_ignore(target, ignore_index):
    if ignore_index == -1:
        target = target.copy()
        target[::5] = -1
    return target


# ------------------------------------------------------------- functional
@pytest.mark.parametrize("fn", sorted(FUNCTIONALS))
@pytest.mark.parametrize("kind", ["scores", "labels", "nan_scores"])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none", "samples"])
@pytest.mark.parametrize("ignore_index", [None, 3, -1])
def test_functional(fn, kind, average, ignore_index):
    preds, target = _inputs(kind, seed=3)
    target = _with_ignore(target, ignore_index)
    (jp, tp), (jt, tt) = _pair(preds), _pair(target)
    kwargs = dict(average=average, num_classes=_num_classes(ignore_index, average), ignore_index=ignore_index,
                  **FUNCTIONALS[fn])
    _same_or_same_error(lambda: getattr(jF, fn)(jp, jt, **kwargs), lambda: getattr(tF, fn)(tp, tt, **kwargs))


@pytest.mark.parametrize("kind", ["scores", "labels", "nan_scores"])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("ignore_index", [None, 3, -1])
def test_functional_precision_recall(kind, average, ignore_index):
    preds, target = _inputs(kind, seed=4)
    target = _with_ignore(target, ignore_index)
    (jp, tp), (jt, tt) = _pair(preds), _pair(target)
    kwargs = dict(average=average, num_classes=_num_classes(ignore_index, average), ignore_index=ignore_index)
    _same_or_same_error(lambda: jF.precision_recall(jp, jt, **kwargs), lambda: tF.precision_recall(tp, tt, **kwargs))


@pytest.mark.parametrize("fn", sorted(FUNCTIONALS))
@pytest.mark.parametrize("mdmc_average", ["global", "samplewise"])
@pytest.mark.parametrize("average", ["micro", "macro", "none"])
@pytest.mark.parametrize("kind", ["scores", "labels"])
def test_functional_multidim(fn, mdmc_average, average, kind):
    rng = np.random.RandomState(5)
    probs = rng.rand(12, C, 5).astype(np.float32)
    target = rng.randint(0, C, (12, 5))
    preds = probs if kind == "scores" else probs.argmax(1)
    (jp, tp), (jt, tt) = _pair(preds), _pair(target)
    kwargs = dict(average=average, mdmc_average=mdmc_average, num_classes=C, **FUNCTIONALS[fn])
    _same_or_same_error(lambda: getattr(jF, fn)(jp, jt, **kwargs), lambda: getattr(tF, fn)(tp, tt, **kwargs))


@pytest.mark.parametrize("fn", sorted(FUNCTIONALS))
@pytest.mark.parametrize("top_k", [1, 2])
def test_functional_top_k(fn, top_k):
    preds, target = _inputs("scores", seed=6)
    (jp, tp), (jt, tt) = _pair(preds), _pair(target)
    kwargs = dict(average="macro", num_classes=C, top_k=top_k, **FUNCTIONALS[fn])
    _same_or_same_error(lambda: getattr(jF, fn)(jp, jt, **kwargs), lambda: getattr(tF, fn)(tp, tt, **kwargs))


@pytest.mark.parametrize("fn", sorted(FUNCTIONALS))
def test_functional_binary_and_multilabel(fn):
    rng = np.random.RandomState(7)
    probs, labels = rng.rand(50).astype(np.float32), rng.randint(0, 2, 50)
    (jp, tp), (jt, tt) = _pair(probs), _pair(labels)
    _same_or_same_error(lambda: getattr(jF, fn)(jp, jt, **FUNCTIONALS[fn]),
                        lambda: getattr(tF, fn)(tp, tt, **FUNCTIONALS[fn]))
    ml_probs, ml_labels = rng.rand(50, 4).astype(np.float32), rng.randint(0, 2, (50, 4))
    (jp, tp), (jt, tt) = _pair(ml_probs), _pair(ml_labels)
    kwargs = dict(average="macro", num_classes=4, **FUNCTIONALS[fn])
    _same_or_same_error(lambda: getattr(jF, fn)(jp, jt, **kwargs), lambda: getattr(tF, fn)(tp, tt, **kwargs))


@pytest.mark.parametrize("fn", sorted(FUNCTIONALS))
@pytest.mark.parametrize(
    "kwargs",
    [dict(average="bad"), dict(mdmc_average="bad"), dict(average="macro"), dict(num_classes=C, ignore_index=C)],
    ids=["average", "mdmc_average", "no num_classes", "ignore_index"],
)
def test_functional_argument_errors(fn, kwargs):
    preds, target = _inputs("scores")
    (jp, tp), (jt, tt) = _pair(preds), _pair(target)
    with pytest.raises(ValueError) as jax_err:
        getattr(jF, fn)(jp, jt, **kwargs)
    with pytest.raises(ValueError) as torch_err:
        getattr(tF, fn)(tp, tt, **kwargs)
    assert str(torch_err.value) == str(jax_err.value)


def test_f1_score_refuses_a_string_in_the_beta_slot():
    preds, target = _inputs("scores")
    with pytest.raises(ValueError, match="ignores `beta`"):
        tF.f1_score(torch.from_numpy(preds), torch.from_numpy(target), "macro")


@pytest.mark.parametrize("kind", ["scores", "labels", "binary", "multilabel", "multidim"])
def test_functional_hamming_distance(kind):
    rng = np.random.RandomState(8)
    if kind in ("scores", "labels"):
        preds, target = _inputs(kind, seed=8)
    elif kind == "binary":
        preds, target = rng.rand(40).astype(np.float32), rng.randint(0, 2, 40)
    elif kind == "multilabel":
        preds, target = rng.rand(40, 5).astype(np.float32), rng.randint(0, 2, (40, 5))
    else:
        preds, target = rng.rand(10, C, 3).astype(np.float32), rng.randint(0, C, (10, 3))
    (jp, tp), (jt, tt) = _pair(preds), _pair(target)
    _same_or_same_error(lambda: jF.hamming_distance(jp, jt), lambda: tF.hamming_distance(tp, tt))
    ref = metrics_tpu.functional.classification.hamming._hamming_distance_update(jp, jt)
    got = metrics_tpu_torch.functional.classification.hamming._hamming_distance_update(tp, tt)
    _assert_same(ref[0], got[0], exact=True)
    assert got[1] == ref[1] and isinstance(got[1], int)


# ---------------------------------------------------------------- modules
def _batches(kind, seed, sizes=(64, 64, 37)):
    return [_inputs(kind, n=n, seed=seed + i) for i, n in enumerate(sizes)]


def _assert_states(jm, tm):
    assert list(jm._defaults) == list(tm._defaults)
    for name in jm._defaults:
        ref, got = getattr(jm, name), getattr(tm, name)
        if isinstance(ref, list):  # list states: equal entries in equal order
            assert isinstance(got, list) and len(got) == len(ref)
            if not ref:
                continue
            ref, got = jnp.concatenate(ref), torch.cat(got)
        _assert_same(ref, got, exact=True)


def _drive(jm, tm, batches):
    for i, (preds, target) in enumerate(batches):
        (jp, tp), (jt, tt) = _pair(preds), _pair(target)
        if i == 1:  # forward: the batch value, and the batch accumulated once
            _assert_same(jm(jp, jt), tm(tp, tt), exact=False)
        else:
            jm.update(jp, jt)
            tm.update(tp, tt)
        _assert_states(jm, tm)
        _assert_same(jm.compute(), tm.compute(), exact=False)
    assert tm._update_count == len(batches) == jm._update_count


@pytest.mark.parametrize("name", sorted(MODULES))
@pytest.mark.parametrize("kind", ["scores", "labels", "nan_scores"])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none", "samples"])
def test_module(name, kind, average):
    kwargs = dict(num_classes=C, average=average, **MODULES[name])
    jm = getattr(metrics_tpu, name)(**kwargs)
    tm = getattr(metrics_tpu_torch, name)(device="cpu", **kwargs)
    _drive(jm, tm, _batches(kind, seed=11))
    tm.reset()
    jm.reset()
    assert tm._update_count == 0
    _assert_states(jm, tm)


@pytest.mark.parametrize("name", sorted(MODULES))
@pytest.mark.parametrize("ignore_index", [3, -1])
@pytest.mark.parametrize("average", ["micro", "macro", "none"])
def test_module_ignore_index(name, ignore_index, average):
    kwargs = dict(num_classes=_num_classes(ignore_index, average), average=average, ignore_index=ignore_index, **MODULES[name])
    try:
        jm = getattr(metrics_tpu, name)(**kwargs)
    except ValueError as jax_err:
        with pytest.raises(ValueError) as torch_err:
            getattr(metrics_tpu_torch, name)(device="cpu", **kwargs)
        assert str(torch_err.value) == str(jax_err)
        return
    tm = getattr(metrics_tpu_torch, name)(device="cpu", **kwargs)
    batches = [(p, _with_ignore(t, ignore_index)) for p, t in _batches("scores", seed=13)]
    _drive(jm, tm, batches)


@pytest.mark.parametrize("name", sorted(MODULES))
@pytest.mark.parametrize("mdmc_average", ["global", "samplewise"])
def test_module_multidim(name, mdmc_average):
    rng = np.random.RandomState(17)
    batches = [(rng.rand(6, C, 4).astype(np.float32), rng.randint(0, C, (6, 4))) for _ in range(3)]
    kwargs = dict(num_classes=C, average="macro", mdmc_average=mdmc_average, **MODULES[name])
    jm = getattr(metrics_tpu, name)(**kwargs)
    tm = getattr(metrics_tpu_torch, name)(device="cpu", **kwargs)
    _drive(jm, tm, batches)


@pytest.mark.parametrize("kind", ["scores", "labels", "nan_scores"])
def test_hamming_distance_module(kind):
    jm, tm = metrics_tpu.HammingDistance(), metrics_tpu_torch.HammingDistance(device="cpu")
    _drive(jm, tm, _batches(kind, seed=19))
    assert tm.correct.dtype == tm.total.dtype == torch.int32


def test_module_argument_errors():
    for name in MODULES:
        with pytest.raises(ValueError) as jax_err:
            getattr(metrics_tpu, name)(average="bad")
        with pytest.raises(ValueError) as torch_err:
            getattr(metrics_tpu_torch, name)(average="bad", device="cpu")
        assert str(torch_err.value) == str(jax_err.value)


# ------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("name,kwargs", [
    *((n, dict(num_classes=C, average="macro", **k)) for n, k in sorted(MODULES.items())),
    ("HammingDistance", {}),
])
def test_state_dict_jax_to_port_to_jax(name, kwargs):
    batches = _batches("scores", seed=29)
    jm = getattr(metrics_tpu, name)(**kwargs)
    jm.persistent(True)
    for preds, target in batches[:2]:
        jm.update(jnp.asarray(preds), jnp.asarray(target))

    tm = getattr(metrics_tpu_torch, name)(device="cpu", **kwargs)
    tm.persistent(True)
    load_jax_state_dict(tm, jm.state_dict())
    _assert_states(jm, tm)
    _assert_same(jm.compute(), tm.compute(), exact=False)

    preds, target = batches[2]
    tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    jm2 = getattr(metrics_tpu, name)(**kwargs)
    jm2.persistent(True)
    jm2.load_state_dict(to_jax_state_dict(tm))  # verifies the port's checksums
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    _assert_states(jm2, tm)
    _assert_same(jm2.compute(), tm.compute(), exact=False)
    assert {k: v for k, v in jm.state_dict().items() if k.startswith("__checksum__")} == {
        k: v for k, v in tm.state_dict().items() if k.startswith("__checksum__")
    }
