"""The port's retrieval slice held against the JAX package on the CPU.

The same seeded numpy inputs go through ``metrics_tpu`` and
``metrics_tpu_torch``. The grouping step (``sorted_by_preds``) must equal
JAX's production formulation ``target[jnp.argsort(-preds, stable=True)]``
bit for bit and in dtype, NaN, signed zeros, infinities and ties included,
and its Pallas kernel (interpret mode, called directly) on finite scores,
which is that kernel's contract. Metric values must agree to ``rtol=1e-6``:
XLA and PyTorch sum float32 terms in another order. Module states must be
equal exactly. The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu.functional as jF
import metrics_tpu_torch
import metrics_tpu_torch.functional as tF
from metrics_tpu.ops.retrieval import _sorted_by_preds_lax, _sorted_by_preds_pallas
from metrics_tpu_torch.interop import load_jax_state_dict, to_jax_state_dict
from metrics_tpu_torch.ops import launches, reset_launches, sorted_by_preds
from metrics_tpu_torch.ops.retrieval import L_MAX
from metrics_tpu_torch.utilities.data import bucket_pow2

RTOL = 1e-6
SPECIAL = np.array([0.0, -0.0, np.nan, -np.inf, 1.0, np.nan, 0.0, -0.0, np.inf], np.float32)


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


# ------------------------------------------------------------ sorted_by_preds
_DTYPES = {"int32": np.int32, "float32": np.float32, "bool": np.bool_}


@pytest.mark.parametrize("n", [1, 5, 128, 129, 1000, 1024])
@pytest.mark.parametrize("dtype", list(_DTYPES))
def test_sorted_by_preds_matches_jax_lax_and_pallas(n, dtype):
    # the grid of tests/ops/test_kernel_parity.py
    rng = np.random.RandomState(n)
    preds = rng.rand(n).astype(np.float32)
    target = rng.randint(0, 2, n).astype(_DTYPES[dtype])
    got = sorted_by_preds(_t(preds), _t(target))
    jp, jt = jnp.asarray(preds), jnp.asarray(target)
    _assert_same(_sorted_by_preds_lax(jp, jt), got, exact=True)
    pallas = _sorted_by_preds_pallas(jp, jt, interpret=True).astype(jt.dtype)
    _assert_same(pallas, got, exact=True)


def test_sorted_by_preds_ties_keep_index_order():
    preds = np.array([0.5, 0.2, 0.5, 0.2, 0.5], np.float32)
    target = np.array([1, 2, 3, 4, 5], np.int32)
    got = sorted_by_preds(_t(preds), _t(target))
    assert got.tolist() == [1, 3, 5, 2, 4]
    _assert_same(_sorted_by_preds_pallas(jnp.asarray(preds), jnp.asarray(target), interpret=True).astype(jnp.int32),
                 got, exact=True)


def _special_rows():
    rng = np.random.RandomState(3)
    rows = {"issue example": SPECIAL, "all nan": np.full(6, np.nan, np.float32)}
    rows["signed zeros"] = np.array([-0.0, 0.0, -0.0, 0.5, 0.0, -0.5], np.float32)
    mixed = (np.round(rng.randn(257) * 4) / 4).astype(np.float32)  # many ties
    mixed[rng.randint(0, 257, 20)] = np.nan
    mixed[rng.randint(0, 257, 10)] = -0.0
    mixed[rng.randint(0, 257, 5)] = np.inf
    mixed[rng.randint(0, 257, 5)] = -np.inf
    rows["mixed 257"] = mixed
    # the edges of the kernel's bitonic branch: one element, a full 1024 row, no order at all
    rows["one"] = np.array([0.5], np.float32)
    rows["all equal 1000"] = np.full(1000, 0.25, np.float32)
    rows["all nan 1024"] = np.full(1024, np.nan, np.float32)
    wide = (np.round(rng.randn(1024) * 4) / 4).astype(np.float32)
    wide[rng.randint(0, 1024, 80)] = np.nan
    wide[rng.randint(0, 1024, 40)] = -0.0
    wide[rng.randint(0, 1024, 20)] = np.inf
    wide[rng.randint(0, 1024, 20)] = -np.inf
    rows["mixed 1024"] = wide
    return rows


@pytest.mark.parametrize("case", list(_special_rows()))
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_sorted_by_preds_nan_signed_zero_and_inf_match_argsort(case, dtype):
    # NaN lies outside the Pallas kernel's contract: rows with NaN are held against the lax path only
    preds = _special_rows()[case]
    target = np.arange(preds.shape[0]).astype(_DTYPES[dtype])
    got = sorted_by_preds(_t(preds), _t(target))
    _assert_same(_sorted_by_preds_lax(jnp.asarray(preds), jnp.asarray(target)), got, exact=True)
    if not np.isnan(preds).any():
        pallas = _sorted_by_preds_pallas(jnp.asarray(preds), jnp.asarray(target), interpret=True)
        _assert_same(pallas.astype(target.dtype), got, exact=True)


def test_sorted_by_preds_issue_order():
    got = sorted_by_preds(_t(SPECIAL), torch.arange(9, dtype=torch.int32))
    assert got.tolist() == [8, 4, 0, 1, 6, 7, 3, 2, 5]


@pytest.mark.parametrize("dtype", ["int32", "float32", "bool"])
def test_sorted_by_preds_rows_match_take_along_axis(dtype):
    rng = np.random.RandomState(7)
    q, l = 6, 16
    preds = (np.round(rng.randn(q, l) * 2) / 2).astype(np.float32)
    preds[0, 3] = np.nan
    preds[1, 5:] = -np.inf  # padding, as the module metrics pad
    preds[2, ::3] = -0.0
    target = rng.randint(0, 3, (q, l)).astype(_DTYPES[dtype])
    got = sorted_by_preds(_t(preds), _t(target))
    jp, jt = jnp.asarray(preds), jnp.asarray(target)
    ref = jnp.take_along_axis(jt, jnp.argsort(-jp, axis=1, stable=True), axis=1)
    _assert_same(ref, got, exact=True)
    for row in range(q):
        _assert_same(_sorted_by_preds_lax(jp[row], jt[row]), got[row], exact=True)


@pytest.mark.parametrize("l", [L_MAX, L_MAX + 1])
def test_sorted_by_preds_rows_either_side_of_the_branch_switch_run_plain_on_the_cpu(l):
    # the kernel's branch changes at L_MAX; a CPU tensor takes the plain version on either side
    rng = np.random.RandomState(l)
    preds = (np.round(rng.randn(2, l) * 4) / 4).astype(np.float32)
    preds[:, rng.randint(0, l, 64)] = np.nan
    preds[:, rng.randint(0, l, 64)] = -0.0
    target = rng.randint(0, 4, (2, l)).astype(np.int32)
    reset_launches()
    got = sorted_by_preds(_t(preds), _t(target))
    jp, jt = jnp.asarray(preds), jnp.asarray(target)
    for row in range(2):
        _assert_same(_sorted_by_preds_lax(jp[row], jt[row]), got[row], exact=True)
    assert launches()["retrieval_sort"] == 0


def test_sorted_by_preds_rejects_bad_shapes_and_counts_no_cpu_launch():
    with pytest.raises(ValueError, match="expects"):
        sorted_by_preds(torch.rand(4), torch.ones(5))
    with pytest.raises(ValueError, match="expects"):
        sorted_by_preds(torch.rand(2, 2, 2), torch.ones(2, 2, 2))
    with pytest.raises(RuntimeError, match="no kernel"):
        sorted_by_preds(torch.rand(4, device="meta"), torch.ones(4, device="meta"))
    reset_launches()
    sorted_by_preds(torch.rand(3, 8), torch.ones(3, 8, dtype=torch.int64))
    assert launches()["retrieval_sort"] == 0


@pytest.mark.parametrize("n,want", [(1, 8), (8, 8), (9, 16), (1000, 1024), (1025, 2048)])
def test_bucket_pow2_matches_jax(n, want):
    from metrics_tpu.utilities.data import bucket_pow2 as jax_bucket_pow2

    assert bucket_pow2(n) == jax_bucket_pow2(n) == want


# --------------------------------------------------------------- functional
_FUNCTIONALS = [
    ("retrieval_average_precision", {}),
    ("retrieval_reciprocal_rank", {}),
    ("retrieval_precision", {}),
    ("retrieval_precision", {"k": 3}),
    ("retrieval_precision", {"k": 50, "adaptive_k": True}),
    ("retrieval_precision", {"k": 50}),
    ("retrieval_recall", {}),
    ("retrieval_recall", {"k": 4}),
    ("retrieval_hit_rate", {"k": 2}),
    ("retrieval_fall_out", {}),
    ("retrieval_fall_out", {"k": 5}),
    ("retrieval_normalized_dcg", {}),
    ("retrieval_normalized_dcg", {"k": 3}),
    ("retrieval_r_precision", {}),
]


@pytest.mark.parametrize("name,kwargs", _FUNCTIONALS, ids=lambda v: str(v))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_functional_matches_jax(name, kwargs, seed):
    rng = np.random.RandomState(seed)
    n = 10 + 7 * seed
    preds = (np.round(rng.rand(n) * 8) / 8).astype(np.float32)  # ties
    hi = 4 if name == "retrieval_normalized_dcg" else 2
    target = rng.randint(0, hi, n).astype(np.int32)
    if seed == 2:
        target[:] = 0  # no relevant document
    ref = getattr(jF, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = getattr(tF, name)(_t(preds), _t(target), **kwargs)
    _assert_same(ref, got, exact=False)


# the reference's recorded doctest values (tests/retrieval/test_retrieval_recorded_oracles.py)
_RECORDED = [
    ("retrieval_average_precision", {}, [0.2, 0.3, 0.5], [True, False, True], 0.8333),
    ("retrieval_fall_out", {"k": 2}, [0.2, 0.3, 0.5], [True, False, True], 1.0),
    ("retrieval_hit_rate", {"k": 2}, [0.2, 0.3, 0.5], [True, False, True], 1.0),
    ("retrieval_precision", {"k": 2}, [0.2, 0.3, 0.5], [True, False, True], 0.5),
    ("retrieval_r_precision", {}, [0.2, 0.3, 0.5], [True, False, True], 0.5),
    ("retrieval_recall", {"k": 2}, [0.2, 0.3, 0.5], [True, False, True], 0.5),
    ("retrieval_reciprocal_rank", {}, [0.2, 0.3, 0.5], [False, True, False], 0.5),
    ("retrieval_normalized_dcg", {}, [0.1, 0.2, 0.3, 4.0, 70.0], [10, 0, 0, 1, 5], 0.6957),
]


@pytest.mark.parametrize("name,kwargs,preds,target,expected", _RECORDED, ids=[r[0] for r in _RECORDED])
def test_functional_recorded_oracles(name, kwargs, preds, target, expected):
    preds, target = np.asarray(preds, np.float32), np.asarray(target)
    if target.dtype == np.int64:
        target = target.astype(np.int32)
    got = getattr(tF, name)(_t(preds), _t(target), **kwargs)
    np.testing.assert_allclose(float(got), expected, atol=1e-4)
    _assert_same(getattr(jF, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs), got, exact=False)


def test_functional_nan_score_goes_last():
    preds = np.array([np.nan, 0.3, 0.5], np.float32)
    target = np.array([1, 0, 0], np.int32)
    ref = jF.retrieval_average_precision(jnp.asarray(preds), jnp.asarray(target))
    got = tF.retrieval_average_precision(_t(preds), _t(target))
    _assert_same(ref, got, exact=False)
    assert abs(float(got) - 1 / 3) < 1e-6


def _raises_alike(make_jax, make_torch):
    with pytest.raises(Exception) as jax_err:
        make_jax()
    with pytest.raises(Exception) as torch_err:
        make_torch()
    assert type(torch_err.value) is type(jax_err.value)
    assert str(torch_err.value) == str(jax_err.value)


_FUNCTIONAL_ERRORS = {
    "shape": ("retrieval_average_precision", np.zeros(3, np.float32), np.zeros(4, np.int32), {}),
    "empty": ("retrieval_recall", np.zeros(0, np.float32), np.zeros(0, np.int32), {}),
    "scalar": ("retrieval_recall", np.zeros((), np.float32), np.zeros((), np.int32), {}),
    "int preds": ("retrieval_hit_rate", np.zeros(3, np.int32), np.zeros(3, np.int32), {}),
    "non-binary": ("retrieval_precision", np.zeros(3, np.float32), np.array([0, 2, 1], np.int32), {}),
    "negative": ("retrieval_fall_out", np.zeros(3, np.float32), np.array([0, -1, 1], np.int32), {}),
    "bad k": ("retrieval_recall", np.zeros(3, np.float32), np.zeros(3, np.int32), {"k": 0}),
    "float k": ("retrieval_normalized_dcg", np.zeros(3, np.float32), np.zeros(3, np.int32), {"k": 1.5}),
    "adaptive_k": ("retrieval_precision", np.zeros(3, np.float32), np.zeros(3, np.int32), {"adaptive_k": 1}),
}


@pytest.mark.parametrize("case", list(_FUNCTIONAL_ERRORS))
def test_functional_errors_match_jax(case):
    name, preds, target, kwargs = _FUNCTIONAL_ERRORS[case]
    _raises_alike(lambda: getattr(jF, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs),
                  lambda: getattr(tF, name)(_t(preds), _t(target), **kwargs))


# ------------------------------------------------------------------ modules
def _queries(seed, n_queries=7, graded=False, empty=True, nan_row=False, ignore=None):
    """Three updates of rows for ``n_queries`` queries of uneven length,
    shuffled across the updates; query 0 has no relevant document when
    ``empty``; ``ignore`` adds rows carrying that target."""
    rng = np.random.RandomState(seed)
    idx, preds, target = [], [], []
    for q in range(n_queries):
        n = rng.randint(1, 13)
        idx += [q + 100] * n
        preds += list(np.round(rng.rand(n) * 10) / 10)  # ties
        hi = 4 if graded else 2
        t = rng.randint(0, hi, n)
        if empty and q == 0:
            t[:] = 0
        elif not t.any():
            t[0] = 1
        target += list(t)
    idx, preds, target = np.array(idx, np.int32), np.array(preds, np.float32), np.array(target, np.int32)
    if nan_row:
        preds[np.flatnonzero(idx == 101)[0]] = np.nan
    if ignore is not None:
        extra = rng.randint(0, len(idx), 6)
        idx = np.concatenate([idx, idx[extra]])
        preds = np.concatenate([preds, rng.rand(6).astype(np.float32)])
        target = np.concatenate([target, np.full(6, ignore, np.int32)])
    order = rng.permutation(len(idx))
    idx, preds, target = idx[order], preds[order], target[order]
    cuts = np.array_split(np.arange(len(idx)), 3)
    return [(idx[c], preds[c], target[c]) for c in cuts]


def _assert_states(jm, tm):
    for name in ("indexes", "preds", "target"):
        ref, got = getattr(jm, name), getattr(tm, name)
        assert isinstance(got, list) and len(got) == len(ref)
        if ref:
            _assert_same(jnp.concatenate(ref), torch.cat(got), exact=True)


def _drive(jm, tm, batches, each_step=True, error=False):
    """Updates (forward on the second batch when ``each_step``), states after
    each, values after each or at the end; with ``error`` the final compute
    must raise alike."""
    for i, (idx, preds, target) in enumerate(batches):
        ja, ta = (jnp.asarray(preds), jnp.asarray(target), jnp.asarray(idx)), (_t(preds), _t(target), _t(idx))
        if i == 1 and each_step:
            _assert_same(jm(*ja), tm(*ta), exact=False)
        else:
            jm.update(*ja)
            tm.update(*ta)
        _assert_states(jm, tm)
        if each_step:
            _assert_same(jm.compute(), tm.compute(), exact=False)
    if error:
        _raises_alike(jm.compute, tm.compute)
    elif not each_step:
        _assert_same(jm.compute(), tm.compute(), exact=False)
    tm.reset()
    jm.reset()
    _assert_states(jm, tm)


_MODULES = ["RetrievalMAP", "RetrievalMRR", "RetrievalPrecision", "RetrievalRecall", "RetrievalHitRate",
            "RetrievalFallOut", "RetrievalNormalizedDCG", "RetrievalRPrecision"]


@pytest.mark.parametrize("metric", _MODULES)
@pytest.mark.parametrize("action", ["neg", "pos", "skip", "error"])
def test_modules_match_jax_for_every_empty_target_action(metric, action):
    # with "error" a partial state may hold a query with no positive yet: values at the end only
    batches = _queries(seed=len(metric) + len(action), empty=action != "error")
    if action == "error" and metric == "RetrievalFallOut":
        batches = [(i, p, 1 - t) for i, p, t in batches]  # every query then has a non-relevant document
    jm = getattr(metrics_tpu, metric)(empty_target_action=action)
    tm = getattr(metrics_tpu_torch, metric)(empty_target_action=action, device="cpu")
    _drive(jm, tm, batches, each_step=action != "error")


@pytest.mark.parametrize("metric", _MODULES)
def test_modules_raise_alike_on_an_empty_query(metric):
    # FallOut's empty query is one without a non-relevant document
    batches = _queries(seed=5, empty=True)
    if metric == "RetrievalFallOut":
        batches = [(i, p, np.where(i == 100, 1, t).astype(np.int32)) for i, p, t in batches]
    jm = getattr(metrics_tpu, metric)(empty_target_action="error")
    tm = getattr(metrics_tpu_torch, metric)(empty_target_action="error", device="cpu")
    _drive(jm, tm, batches, each_step=False, error=True)


_TOPK = [(m, k) for m in ("RetrievalPrecision", "RetrievalRecall", "RetrievalHitRate", "RetrievalFallOut",
                          "RetrievalNormalizedDCG") for k in (1, 3, 20)]


@pytest.mark.parametrize("metric,k", _TOPK)
def test_topk_modules_match_jax(metric, k):
    jm = getattr(metrics_tpu, metric)(k=k)
    tm = getattr(metrics_tpu_torch, metric)(k=k, device="cpu")
    _drive(jm, tm, _queries(seed=k + len(metric)))


@pytest.mark.parametrize("k", [None, 2, 5, 40])
def test_precision_adaptive_k_matches_jax(k):
    jm = metrics_tpu.RetrievalPrecision(k=k, adaptive_k=True)
    tm = metrics_tpu_torch.RetrievalPrecision(k=k, adaptive_k=True, device="cpu")
    _drive(jm, tm, _queries(seed=11))


@pytest.mark.parametrize("k", [None, 3])
def test_graded_ndcg_matches_jax(k):
    jm = metrics_tpu.RetrievalNormalizedDCG(k=k)
    tm = metrics_tpu_torch.RetrievalNormalizedDCG(k=k, device="cpu")
    _drive(jm, tm, _queries(seed=13, graded=True))


@pytest.mark.parametrize("metric", ["RetrievalMAP", "RetrievalRecall", "RetrievalNormalizedDCG"])
def test_ignore_index_matches_jax(metric):
    jm = getattr(metrics_tpu, metric)(ignore_index=-100)
    tm = getattr(metrics_tpu_torch, metric)(ignore_index=-100, device="cpu")
    _drive(jm, tm, _queries(seed=17, ignore=-100))


@pytest.mark.parametrize("metric", _MODULES)
def test_nan_score_row_follows_the_padded_length(metric):
    # a NaN score sorts after the -inf pads, so its rank is the padded length
    jm = getattr(metrics_tpu, metric)()
    tm = getattr(metrics_tpu_torch, metric)(device="cpu")
    _drive(jm, tm, _queries(seed=19, nan_row=True))


def test_nan_score_row_value_depends_on_the_longest_query():
    def run(pkg, prep, extra, **dev):
        m = pkg.RetrievalMAP(**dev)
        idx, p, t = [0, 0, 0], [np.nan, 0.3, 0.5], [1, 0, 0]
        if extra:
            idx, p, t = idx + [1] * 9, p + list(np.linspace(0, 1, 9)), t + [1, 0] * 4 + [1]
        m.update(prep(np.array(p, np.float32)), prep(np.array(t, np.int32)), prep(np.array(idx, np.int32)))
        return m.compute()

    for extra in (False, True):
        ref = run(metrics_tpu, jnp.asarray, extra)
        got = run(metrics_tpu_torch, _t, extra, device="cpu")
        _assert_same(ref, got, exact=False)
    alone = float(run(metrics_tpu_torch, _t, False, device="cpu"))
    assert alone == 0.125  # AP 1/8: the NaN document ranks after 5 pads of L = 8


def test_public_attribute_write_drops_the_memoised_compute():
    batches = _queries(seed=23)
    jm, tm = metrics_tpu.RetrievalPrecision(k=5), metrics_tpu_torch.RetrievalPrecision(k=5, device="cpu")
    for idx, preds, target in batches:
        jm.update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(idx))
        tm.update(_t(preds), _t(target), _t(idx))
    first = tm.compute()
    _assert_same(jm.compute(), first, exact=False)
    assert tm._computed is not None
    tm.k, jm.k = 1, 1
    assert tm._computed is None
    second = tm.compute()
    _assert_same(jm.compute(), second, exact=False)
    assert float(second) != float(first)
    tm.some_threshold = 0.5  # any public attribute
    assert tm._computed is None


def test_module_constructor_and_update_errors_match_jax():
    _raises_alike(lambda: metrics_tpu.RetrievalMAP(empty_target_action="casual"),
                  lambda: metrics_tpu_torch.RetrievalMAP(empty_target_action="casual", device="cpu"))
    _raises_alike(lambda: metrics_tpu.RetrievalMAP(ignore_index=1.5),
                  lambda: metrics_tpu_torch.RetrievalMAP(ignore_index=1.5, device="cpu"))
    _raises_alike(lambda: metrics_tpu.RetrievalRecall(k=-1),
                  lambda: metrics_tpu_torch.RetrievalRecall(k=-1, device="cpu"))
    _raises_alike(lambda: metrics_tpu.RetrievalPrecision(adaptive_k=2),
                  lambda: metrics_tpu_torch.RetrievalPrecision(adaptive_k=2, device="cpu"))
    p, t = np.array([0.1, 0.2], np.float32), np.array([0, 1], np.int32)
    for idx in (np.array([0.0, 1.0], np.float32), np.array([0, 1, 2], np.int32)):
        _raises_alike(lambda: metrics_tpu.RetrievalMAP().update(jnp.asarray(p), jnp.asarray(t), jnp.asarray(idx)),
                      lambda: metrics_tpu_torch.RetrievalMAP(device="cpu").update(_t(p), _t(t), _t(idx)))
    _raises_alike(lambda: metrics_tpu.RetrievalMAP().update(jnp.asarray(p), jnp.asarray(t), None),
                  lambda: metrics_tpu_torch.RetrievalMAP(device="cpu").update(_t(p), _t(t), None))


class _LoopedRecall(metrics_tpu_torch.RetrievalMetric):
    """A subclass with only ``_metric``: the default host loop."""

    def _metric(self, preds, target):
        return tF.retrieval_recall(preds, target, k=2)


def test_default_host_loop_warns_once_and_matches_the_batched_metric():
    batches = _queries(seed=29)
    looped, batched = _LoopedRecall(device="cpu"), metrics_tpu_torch.RetrievalRecall(k=2, device="cpu")
    for idx, preds, target in batches:
        looped.update(_t(preds), _t(target), _t(idx))
        batched.update(_t(preds), _t(target), _t(idx))
    with pytest.warns(UserWarning, match="host loop"):
        value = looped.compute()
    torch.testing.assert_close(value, batched.compute(), rtol=RTOL, atol=0)


# -------------------------------------------------------------- checkpoints
def test_list_state_dict_jax_to_port_to_jax():
    batches = _queries(seed=31)
    jm = metrics_tpu.RetrievalMAP()
    jm.persistent(True)
    for idx, preds, target in batches[:2]:
        jm.update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(idx))
    tm = metrics_tpu_torch.RetrievalMAP(device="cpu")
    tm.persistent(True)
    load_jax_state_dict(tm, jm.state_dict())
    _assert_states(jm, tm)
    _assert_same(jm.compute(), tm.compute(), exact=False)

    idx, preds, target = batches[2]
    tm.update(_t(preds), _t(target), _t(idx))
    jm.update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(idx))
    jm2 = metrics_tpu.RetrievalMAP()
    jm2.persistent(True)
    jm2.load_state_dict(to_jax_state_dict(tm))
    _assert_states(jm2, tm)
    _assert_same(jm.compute(), tm.compute(), exact=False)
    _assert_same(jm2.compute(), tm.compute(), exact=False)
