"""The port's regression metrics held against the JAX package on the CPU.

Built from the cases of ``tests/regression/test_regression.py``: the twelve
functionals and their modules, ``multioutput``, ``adjusted`` and its
warnings, every Tweedie power and its errors, Spearman's ranks (ties, NaN,
+-0, and base ranks past 2**24), Pearson's merge of stacked states, the
engines and ``compute_on_cpu``. The same seeded numpy inputs go through
``metrics_tpu`` and ``metrics_tpu_torch``. Tolerances:

* bit-equal: integer states (``total``, ``num_observations``), Spearman's
  ranks, the dtypes and shapes of every state and value, and the port's
  engine states against its eager states;
* rtol 1e-5, atol 1e-6, NaN equal to NaN: every float value and state (float32
  sums that XLA and PyTorch add in other orders), and the gradients of the
  differentiable functionals (``torch.autograd`` against ``jax.grad``).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu.functional as jF
import metrics_tpu_torch as M
import metrics_tpu_torch.functional as tF
from metrics_tpu.functional.regression.spearman import _rank_data as jax_rank_data
from metrics_tpu.regression.pearson import _final_aggregation as jax_final_aggregation
from metrics_tpu_torch.functional.regression.spearman import _rank_data
from metrics_tpu_torch.interop import load_jax_state_dict, to_jax_state_dict
from metrics_tpu_torch.regression.pearson import _final_aggregation

RTOL, ATOL = 1e-5, 1e-6
NUM_BATCHES, BATCH, OUTPUTS = 4, 32, 3

# (class, functional, constructor / functional arguments, positive inputs only)
SIMPLE = {
    "mse": ("MeanSquaredError", "mean_squared_error", {}),
    "rmse": ("MeanSquaredError", "mean_squared_error", {"squared": False}),
    "mae": ("MeanAbsoluteError", "mean_absolute_error", {}),
    "msle": ("MeanSquaredLogError", "mean_squared_log_error", {}),
    "mape": ("MeanAbsolutePercentageError", "mean_absolute_percentage_error", {}),
    "smape": ("SymmetricMeanAbsolutePercentageError", "symmetric_mean_absolute_percentage_error", {}),
    "wmape": ("WeightedMeanAbsolutePercentageError", "weighted_mean_absolute_percentage_error", {}),
    "tweedie": ("TweedieDevianceScore", "tweedie_deviance_score", {"power": 0.0}),
}
TWEEDIE_POWERS = (-1.0, -0.5, 0.0, 1.0, 1.5, 2.0, 2.5, 3.0)
MULTIOUTPUTS = ("raw_values", "uniform_average", "variance_weighted")
# the modules whose states are all tensors: the engines serve them
TENSOR_STATE = {
    "mse": ("MeanSquaredError", {}),
    "mae": ("MeanAbsoluteError", {}),
    "msle": ("MeanSquaredLogError", {}),
    "mape": ("MeanAbsolutePercentageError", {}),
    "smape": ("SymmetricMeanAbsolutePercentageError", {}),
    "wmape": ("WeightedMeanAbsolutePercentageError", {}),
    "tweedie": ("TweedieDevianceScore", {"power": 1.5}),
    "r2": ("R2Score", {}),
    "explained_variance": ("ExplainedVariance", {}),
    "pearson": ("PearsonCorrCoef", {}),
}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert(ref, got, exact=False):
    ref, got = np.asarray(ref), _np(got)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if exact or not np.issubdtype(ref.dtype, np.floating):
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL, equal_nan=True)


def _assert_states(jm, tm):
    assert list(jm._defaults) == list(tm._defaults)
    for key in jm._defaults:
        j, t = getattr(jm, key), getattr(tm, key)
        if isinstance(j, list):
            assert len(j) == len(t), key
            for a, b in zip(j, t):
                _assert(a, b)
        else:
            _assert(j, t)


def _same_error(jax_call, torch_call, kind=Exception):
    with pytest.raises(kind) as jax_err:
        jax_call()
    with pytest.raises(kind) as torch_err:
        torch_call()
    assert type(torch_err.value) is type(jax_err.value)
    assert str(torch_err.value) == str(jax_err.value)


def _inputs(seed=0, outputs=None, positive=True, n=NUM_BATCHES * BATCH):
    """``n`` rows (``(n, outputs)`` where given) of preds and target: positive
    (0.1 to 1.1) for the metrics of logs, percentages and deviances."""
    rng = np.random.RandomState(seed)
    shape = (n,) if outputs is None else (n, outputs)
    preds = rng.rand(*shape).astype(np.float32)
    target = (0.5 * preds + 0.5 * rng.rand(*shape)).astype(np.float32)
    if positive:
        return preds + np.float32(0.1), target + np.float32(0.1)
    return 2 * preds - 1, 2 * target - 1


def _batches(preds, target):
    return [(preds[i:i + BATCH], target[i:i + BATCH]) for i in range(0, preds.shape[0], BATCH)]


def _jax_and_port(cls, kwargs=None, **port_kwargs):
    kwargs = kwargs or {}
    return getattr(J, cls)(**kwargs), getattr(M, cls)(**kwargs, device="cpu", **port_kwargs)


def _run_modules(jm, tm, preds, target, forward=True):
    """Every batch through both modules (``forward`` values compared), then compute."""
    for p, t in _batches(preds, target):
        if forward:
            _assert(jm(jnp.asarray(p), jnp.asarray(t)), tm(_t(p), _t(t)))
        else:
            jm.update(jnp.asarray(p), jnp.asarray(t))
            tm.update(_t(p), _t(t))
    _assert_states(jm, tm)
    _assert(jm.compute(), tm.compute())


# ------------------------------------------------------------------ functionals
@pytest.mark.parametrize("outputs", [None, OUTPUTS], ids=["1d", "2d"])
@pytest.mark.parametrize("case", sorted(SIMPLE))
def test_simple_functional_equals_jax(case, outputs):
    _, fn, kwargs = SIMPLE[case]
    preds, target = _inputs(outputs=outputs)
    _assert(getattr(jF, fn)(jnp.asarray(preds), jnp.asarray(target), **kwargs),
            getattr(tF, fn)(_t(preds), _t(target), **kwargs))


@pytest.mark.parametrize("case", sorted(SIMPLE))
def test_simple_module_equals_jax(case):
    cls, _, kwargs = SIMPLE[case]
    jm, tm = _jax_and_port(cls, kwargs)
    _run_modules(jm, tm, *_inputs(seed=1))
    if "total" in tm._defaults:
        # int32 counts, except the MAPE family's float32 (metrics_tpu/regression/mape.py:36)
        want = torch.float32 if case in ("mape", "smape") else torch.int32
        assert tm.total.dtype == want and int(tm.total) == NUM_BATCHES * BATCH


def test_mae_on_integer_inputs_equals_jax():
    rng = np.random.RandomState(2)
    preds, target = rng.randint(0, 10, size=40).astype(np.int32), rng.randint(0, 10, size=40).astype(np.int32)
    _assert(jF.mean_absolute_error(jnp.asarray(preds), jnp.asarray(target)),
            tF.mean_absolute_error(_t(preds), _t(target)))


def test_epsilon_clamps_of_the_mape_family_equal_jax():
    """Zero targets (and a zero prediction) hit the clamp at 1.17e-06."""
    preds = np.asarray([0.0, 1.0, 2.0, 1e-7, 3.0], np.float32)
    target = np.asarray([0.0, 0.0, 2.0, 0.0, -1.0], np.float32)
    for fn in ("mean_absolute_percentage_error", "symmetric_mean_absolute_percentage_error",
               "weighted_mean_absolute_percentage_error"):
        _assert(getattr(jF, fn)(jnp.asarray(preds), jnp.asarray(target)), getattr(tF, fn)(_t(preds), _t(target)))
    zero = np.zeros(3, np.float32)
    _assert(jF.weighted_mean_absolute_percentage_error(jnp.asarray(zero + 1), jnp.asarray(zero)),
            tF.weighted_mean_absolute_percentage_error(_t(zero + 1), _t(zero)))


# ---------------------------------------------------------------------- Tweedie
@pytest.mark.parametrize("power", TWEEDIE_POWERS)
def test_tweedie_every_power_equals_jax(power):
    preds, target = _inputs(seed=3)
    if 1 <= power < 2:
        target[::5] = 0.0  # Poisson and compound Poisson-gamma: zero claims
    _assert(jF.tweedie_deviance_score(jnp.asarray(preds), jnp.asarray(target), power=power),
            tF.tweedie_deviance_score(_t(preds), _t(target), power=power))
    jm, tm = _jax_and_port("TweedieDevianceScore", {"power": power})
    _run_modules(jm, tm, preds, target)
    assert tm.num_observations.dtype == torch.int32


@pytest.mark.parametrize("power,bad", [
    (-1.0, "preds"), (1.0, "preds"), (1.0, "target"), (1.5, "preds"), (1.5, "target"),
    (2.0, "preds"), (2.0, "target"), (3.0, "preds"), (3.0, "target"),
])
def test_tweedie_value_errors_equal_jax(power, bad):
    preds, target = _inputs(seed=4)
    if bad == "preds":
        preds[3] = 0.0
    else:
        target[3] = -1.0
    _same_error(lambda: jF.tweedie_deviance_score(jnp.asarray(preds), jnp.asarray(target), power=power),
                lambda: tF.tweedie_deviance_score(_t(preds), _t(target), power=power), ValueError)
    jm, tm = _jax_and_port("TweedieDevianceScore", {"power": power})
    _same_error(lambda: jm.update(jnp.asarray(preds), jnp.asarray(target)),
                lambda: tm.update(_t(preds), _t(target)), ValueError)


def test_tweedie_power_between_0_and_1_raises_like_jax():
    preds, target = _inputs()
    _same_error(lambda: jF.tweedie_deviance_score(jnp.asarray(preds), jnp.asarray(target), power=0.5),
                lambda: tF.tweedie_deviance_score(_t(preds), _t(target), power=0.5), ValueError)
    _same_error(lambda: J.TweedieDevianceScore(power=0.5), lambda: M.TweedieDevianceScore(power=0.5, device="cpu"),
                ValueError)


def test_tweedie_engine_skips_the_value_checks_like_jax_jit():
    """Under ``jit_update`` neither package reads the values: a negative
    target, which an eager update refuses, goes into the sum (its first term
    clamped at 0) in both."""
    preds, target = _inputs(seed=5)
    target[0] = -1.0
    with pytest.raises(ValueError, match="cannot be negative"):
        M.TweedieDevianceScore(power=1.5, device="cpu").update(_t(preds), _t(target))
    jm, tm = _jax_and_port("TweedieDevianceScore", {"power": 1.5, "jit_update": True})
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    tm.update(_t(preds), _t(target))
    _assert_states(jm, tm)
    _assert(jm.compute(), tm.compute())


# -------------------------------------------------------- R2, explained variance
@pytest.mark.parametrize("multioutput", MULTIOUTPUTS)
def test_r2_and_explained_variance_functionals_equal_jax(multioutput):
    preds, target = _inputs(seed=6, outputs=OUTPUTS, positive=False)
    for fn in ("r2_score", "explained_variance"):
        _assert(getattr(jF, fn)(jnp.asarray(preds), jnp.asarray(target), multioutput=multioutput),
                getattr(tF, fn)(_t(preds), _t(target), multioutput=multioutput))


@pytest.mark.parametrize("multioutput", MULTIOUTPUTS)
def test_r2_module_with_num_outputs_equals_jax(multioutput):
    jm, tm = _jax_and_port("R2Score", {"num_outputs": OUTPUTS, "multioutput": multioutput})
    _run_modules(jm, tm, *_inputs(seed=7, outputs=OUTPUTS, positive=False))
    assert tm.total.dtype == torch.int32 and tm.residual.shape == (OUTPUTS,)


@pytest.mark.parametrize("adjusted", [0, 1, 5])
def test_r2_adjusted_equals_jax(adjusted):
    preds, target = _inputs(seed=8, positive=False)
    _assert(jF.r2_score(jnp.asarray(preds), jnp.asarray(target), adjusted=adjusted),
            tF.r2_score(_t(preds), _t(target), adjusted=adjusted))
    jm, tm = _jax_and_port("R2Score", {"adjusted": adjusted})
    _run_modules(jm, tm, preds, target)


@pytest.mark.parametrize("rows,message", [(10, "More independent regressions"), (11, "Division by zero")])
def test_r2_adjusted_warnings_equal_jax(rows, message):
    preds, target = _inputs(seed=9, n=rows, positive=False)
    for pkg, arr in ((J, jnp.asarray), (M, _t)):
        metric = pkg.R2Score(adjusted=10) if pkg is J else pkg.R2Score(adjusted=10, device="cpu")
        with pytest.warns(UserWarning, match=message):
            value = metric(arr(preds), arr(target))
    _assert(J.R2Score()(jnp.asarray(preds), jnp.asarray(target)), value)  # falls back to the plain r2


def test_r2_errors_equal_jax():
    preds, target = _inputs(seed=10, positive=False)
    _same_error(lambda: J.R2Score(adjusted=-1), lambda: M.R2Score(adjusted=-1, device="cpu"), ValueError)
    _same_error(lambda: J.R2Score(multioutput="bad"), lambda: M.R2Score(multioutput="bad", device="cpu"), ValueError)
    _same_error(lambda: jF.r2_score(jnp.asarray(preds), jnp.asarray(target), multioutput="bad"),
                lambda: tF.r2_score(_t(preds), _t(target), multioutput="bad"), ValueError)
    _same_error(lambda: jF.r2_score(jnp.asarray(preds), jnp.asarray(target), adjusted=-2),
                lambda: tF.r2_score(_t(preds), _t(target), adjusted=-2), ValueError)
    cube = np.zeros((4, 5, 2), np.float32)
    _same_error(lambda: J.R2Score()(jnp.asarray(cube), jnp.asarray(cube)),
                lambda: M.R2Score(device="cpu")(_t(cube), _t(cube)), ValueError)
    one = np.ones(1, np.float32)
    _same_error(lambda: J.R2Score()(jnp.asarray(one), jnp.asarray(one)),
                lambda: M.R2Score(device="cpu")(_t(one), _t(one)), ValueError)
    _same_error(lambda: jF.r2_score(jnp.asarray(one), jnp.asarray(one)), lambda: tF.r2_score(_t(one), _t(one)),
                ValueError)


def test_r2_two_single_sample_updates_compute_like_jax():
    jm, tm = _jax_and_port("R2Score")
    for p, t in (([1.0], [2.0]), ([2.0], [1.0])):
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(torch.tensor(p), torch.tensor(t))
    _assert_states(jm, tm)
    _assert(jm.compute(), tm.compute())


@pytest.mark.parametrize("multioutput", MULTIOUTPUTS)
def test_explained_variance_module_equals_jax(multioutput):
    jm, tm = _jax_and_port("ExplainedVariance", {"multioutput": multioutput})
    _run_modules(jm, tm, *_inputs(seed=11, outputs=OUTPUTS, positive=False))
    assert tm.sum_error.shape == (OUTPUTS,) and tm.n_obs.dtype == torch.float32


def test_explained_variance_constant_columns_equal_jax():
    """A column the model gets exactly right (numerator 0) and a constant
    target (denominator 0): the scores 1.0 and 0.0 of both branches."""
    preds, target = _inputs(seed=12, outputs=4, positive=False)
    preds[:, 1] = target[:, 1]
    target[:, 2] = 0.5
    for multioutput in MULTIOUTPUTS:
        _assert(jF.explained_variance(jnp.asarray(preds), jnp.asarray(target), multioutput=multioutput),
                tF.explained_variance(_t(preds), _t(target), multioutput=multioutput))


def test_explained_variance_errors_equal_jax():
    preds, target = _inputs()
    _same_error(lambda: J.ExplainedVariance(multioutput="bad"),
                lambda: M.ExplainedVariance(multioutput="bad", device="cpu"), ValueError)
    _same_error(lambda: jF.explained_variance(jnp.asarray(preds), jnp.asarray(target), multioutput="bad"),
                lambda: tF.explained_variance(_t(preds), _t(target), multioutput="bad"), ValueError)


# ------------------------------------------------------------ cosine similarity
@pytest.mark.parametrize("reduction", ["sum", "mean", "none", None])
def test_cosine_similarity_equals_jax(reduction):
    preds, target = _inputs(seed=13, outputs=8, positive=False)
    _assert(jF.cosine_similarity(jnp.asarray(preds), jnp.asarray(target), reduction=reduction),
            tF.cosine_similarity(_t(preds), _t(target), reduction=reduction))
    jm, tm = _jax_and_port("CosineSimilarity", {"reduction": reduction})
    _run_modules(jm, tm, preds, target)


def test_cosine_similarity_casts_to_float32_and_errors_like_jax():
    rng = np.random.RandomState(14)
    preds, target = rng.randint(-5, 6, size=(6, 4)).astype(np.int32), rng.randint(-5, 6, size=(6, 4)).astype(np.int32)
    _assert(jF.cosine_similarity(jnp.asarray(preds), jnp.asarray(target)), tF.cosine_similarity(_t(preds), _t(target)))
    _same_error(lambda: J.CosineSimilarity(reduction="max"),
                lambda: M.CosineSimilarity(reduction="max", device="cpu"), ValueError)
    _same_error(lambda: jF.cosine_similarity(jnp.asarray(preds), jnp.asarray(target), reduction="max"),
                lambda: tF.cosine_similarity(_t(preds), _t(target), reduction="max"), KeyError)


# ------------------------------------------------------------------- Pearson
def test_pearson_functional_and_module_equal_jax():
    preds, target = _inputs(seed=15, positive=False)
    _assert(jF.pearson_corrcoef(jnp.asarray(preds), jnp.asarray(target)), tF.pearson_corrcoef(_t(preds), _t(target)))
    jm, tm = _jax_and_port("PearsonCorrCoef")
    _run_modules(jm, tm, preds, target)
    assert M.PearsonCorrCoef.full_state_update is True


def test_pearson_on_integer_inputs_equals_jax():
    rng = np.random.RandomState(16)
    preds, target = rng.randint(0, 20, size=50).astype(np.int32), rng.randint(0, 20, size=50).astype(np.int32)
    _assert(jF.pearson_corrcoef(jnp.asarray(preds), jnp.asarray(target)), tF.pearson_corrcoef(_t(preds), _t(target)))


def _shard_states(pkg, shards):
    """Each shard's Pearson states, stacked by state in shard order as a sync's gather stacks them."""
    states = []
    for p, t in shards:
        m = pkg.PearsonCorrCoef() if pkg is J else pkg.PearsonCorrCoef(device="cpu")
        m.update(jnp.asarray(p) if pkg is J else _t(p), jnp.asarray(t) if pkg is J else _t(t))
        states.append([getattr(m, k) for k in m._defaults])
    stack = jnp.stack if pkg is J else torch.stack
    return [stack([s[i] for s in states]) for i in range(6)]


def test_pearson_merge_of_uneven_stacked_states_is_bit_equal_to_jax():
    """Four shards of 1, 7, 20 and 100 rows: the port's left-to-right merge
    gives the JAX package's ``lax.scan`` bits, and the merged compute equals
    the single-instance value."""
    preds, target = _inputs(seed=17, n=128, positive=False)
    bounds = [0, 1, 8, 28, 128]
    shards = [(preds[a:b], target[a:b]) for a, b in zip(bounds, bounds[1:])]
    j_states, t_states = _shard_states(J, shards), _shard_states(M, shards)
    for a, b in zip(j_states, t_states):
        _assert(a, b)
    j_merged = jax_final_aggregation(*(s.reshape(-1) for s in j_states))
    t_merged = _final_aggregation(*(_t(np.array(s)).reshape(-1) for s in j_states))
    for a, b in zip(j_merged, t_merged):
        _assert(a, b, exact=True)
    jm, tm = _jax_and_port("PearsonCorrCoef")
    for key, j, t in zip(jm._defaults, j_states, t_states):
        object.__setattr__(jm, key, j)
        object.__setattr__(tm, key, t)
    jm._update_count = tm._update_count = 1
    _assert(jm.compute(), tm.compute())
    single = tF.pearson_corrcoef(_t(preds), _t(target))
    np.testing.assert_allclose(_np(tm.compute()), _np(single), rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------------ Spearman
def test_rank_data_with_ties_nan_and_signed_zeros_is_bit_equal_to_jax():
    rng = np.random.RandomState(18)
    data = np.round(rng.randn(2000) * 3).astype(np.float32)  # about 20 distinct values: large tie groups
    data[::37] = np.nan
    data[1::11] = -0.0
    data[2::11] = 0.0
    data[3::101] = np.inf
    data[4::103] = -np.inf
    _assert(jax_rank_data(jnp.asarray(data)), _rank_data(_t(data)), exact=True)


def test_rank_data_past_2_to_the_24_is_bit_equal_to_jax():
    """n = 2**24 + 4,096: the base ranks are ``float32(i) + 1``
    (``jnp.arange(1, n + 1, dtype=float32)``'s bits), which
    ``torch.arange(1, n + 1, dtype=torch.float32)`` is not from index
    16,777,218 on."""
    n = 2**24 + 4096
    base = torch.arange(n, dtype=torch.float32) + 1
    _assert(jnp.arange(1, n + 1, dtype=jnp.float32), base, exact=True)
    naive = torch.arange(1, n + 1, dtype=torch.float32)
    assert int(torch.nonzero(naive != base)[0]) == 16_777_218
    del naive
    data = np.random.RandomState(19).randn(n).astype(np.float32)
    _assert(jax_rank_data(jnp.asarray(data)), _rank_data(_t(data)), exact=True)


def test_spearman_functional_and_module_equal_jax():
    preds, target = _inputs(seed=20, positive=False)
    preds = np.round(preds * 8) / 8  # ties
    _assert(jF.spearman_corrcoef(jnp.asarray(preds), jnp.asarray(target)),
            tF.spearman_corrcoef(_t(preds), _t(target)))
    jm, tm = _jax_and_port("SpearmanCorrCoef")
    _run_modules(jm, tm, preds, target)


def test_spearman_with_ties_and_nan_equals_jax():
    preds = np.asarray([1.0, 2.0, 2.0, np.nan, 3.0, -0.0, 0.0, 2.0], np.float32)
    target = np.asarray([0.5, 0.5, 1.0, 2.0, np.nan, 0.0, 0.0, 3.0], np.float32)
    _assert(jF.spearman_corrcoef(jnp.asarray(preds), jnp.asarray(target)), tF.spearman_corrcoef(_t(preds), _t(target)))


def test_spearman_compute_on_cpu_equals_jax():
    preds, target = _inputs(seed=21, positive=False)
    jm, tm = _jax_and_port("SpearmanCorrCoef", compute_on_cpu=True)
    _run_modules(jm, tm, preds, target, forward=False)
    assert all(v.device.type == "cpu" for v in tm.preds + tm.target)


def test_spearman_errors_equal_jax():
    a, b = np.zeros(5, np.float32), np.zeros(5, np.int32)
    _same_error(lambda: jF.spearman_corrcoef(jnp.asarray(a), jnp.asarray(b)),
                lambda: tF.spearman_corrcoef(_t(a), _t(b)), TypeError)


@pytest.mark.parametrize("cls", ["PearsonCorrCoef", "SpearmanCorrCoef"])
def test_correlation_multidim_error_equals_jax(cls):
    x = np.zeros((10, 5), np.float32)
    jm, tm = _jax_and_port(cls)
    _same_error(lambda: jm(jnp.asarray(x), jnp.asarray(x)), lambda: tm(_t(x), _t(x)), ValueError)


@pytest.mark.parametrize("cls", [
    "MeanSquaredError", "MeanAbsoluteError", "MeanSquaredLogError", "MeanAbsolutePercentageError",
    "SymmetricMeanAbsolutePercentageError", "WeightedMeanAbsolutePercentageError", "TweedieDevianceScore",
    "R2Score", "PearsonCorrCoef", "SpearmanCorrCoef", "ExplainedVariance", "CosineSimilarity",
])
def test_error_on_different_shape_equals_jax(cls):
    jm, tm = _jax_and_port(cls)
    _same_error(lambda: jm(jnp.zeros(100), jnp.zeros(50)), lambda: tm(torch.zeros(100), torch.zeros(50)),
                RuntimeError)


# ------------------------------------------------------------------ gradients
GRADIENT_CASES = {
    "mean_squared_error": {}, "mean_absolute_error": {}, "mean_squared_log_error": {},
    "mean_absolute_percentage_error": {}, "symmetric_mean_absolute_percentage_error": {},
    "weighted_mean_absolute_percentage_error": {}, "tweedie_deviance_score": {"power": 1.5},
    "explained_variance": {}, "r2_score": {}, "cosine_similarity": {}, "pearson_corrcoef": {},
}
GRADIENT_CLASSES = {
    "mean_squared_error": "MeanSquaredError", "mean_absolute_error": "MeanAbsoluteError",
    "mean_squared_log_error": "MeanSquaredLogError", "mean_absolute_percentage_error": "MeanAbsolutePercentageError",
    "symmetric_mean_absolute_percentage_error": "SymmetricMeanAbsolutePercentageError",
    "weighted_mean_absolute_percentage_error": "WeightedMeanAbsolutePercentageError",
    "tweedie_deviance_score": "TweedieDevianceScore", "explained_variance": "ExplainedVariance",
    "r2_score": "R2Score", "cosine_similarity": "CosineSimilarity", "pearson_corrcoef": "PearsonCorrCoef",
}


@pytest.mark.parametrize("fn", sorted(GRADIENT_CASES))
def test_gradients_equal_jax_grad(fn):
    assert getattr(M, GRADIENT_CLASSES[fn]).is_differentiable is True
    assert getattr(J, GRADIENT_CLASSES[fn]).is_differentiable is True
    kwargs = GRADIENT_CASES[fn]
    outputs = 4 if fn == "cosine_similarity" else None
    preds, target = _inputs(seed=22, outputs=outputs, n=24)
    j_grad = jax.grad(lambda p: getattr(jF, fn)(p, jnp.asarray(target), **kwargs))(jnp.asarray(preds))
    p = _t(preds.copy()).requires_grad_(True)
    (t_grad,) = torch.autograd.grad(getattr(tF, fn)(p, _t(target), **kwargs), p)
    _assert(j_grad, t_grad)


def test_spearman_is_not_differentiable_in_either_package():
    assert M.SpearmanCorrCoef.is_differentiable is False and J.SpearmanCorrCoef.is_differentiable is False


# -------------------------------------------------------------------- engines
@pytest.mark.parametrize("case", sorted(TENSOR_STATE))
def test_engine_states_bit_equal_to_eager_and_to_jax_engine(case):
    """``jit_update=True``: the port's engine gives its eager states bit for
    bit, the JAX engine's to the tolerance, and the same ``dispatches`` and
    ``retraces`` (no masked update: one program a batch shape)."""
    cls, kwargs = TENSOR_STATE[case]
    preds, target = _inputs(seed=23, positive=case not in ("r2", "explained_variance", "pearson"))
    eager = getattr(M, cls)(**kwargs, device="cpu")
    jm, tm = _jax_and_port(cls, {**kwargs, "jit_update": True})
    for p, t in _batches(preds, target) + [(preds[:5], target[:5])]:
        eager.update(_t(p), _t(t))
        tm.update(_t(p), _t(t))
        jm.update(jnp.asarray(p), jnp.asarray(t))
    for key in eager._defaults:
        _assert(getattr(eager, key), getattr(tm, key), exact=True)
    _assert_states(jm, tm)
    _assert(jm.compute(), tm.compute())
    for stat in ("dispatches", "retraces", "demotions"):
        assert tm.dispatch_stats[stat] == jm.dispatch_stats[stat], (stat, tm.dispatch_stats, jm.dispatch_stats)


@pytest.mark.parametrize("case", ["mse", "pearson", "r2"])
def test_fused_forward_equals_eager_forward_and_jax(case):
    """The fused forward (Pearson: ``full_state_update=True``; MSE and R2:
    ``False``) gives the eager forward's batch values and states bit for bit."""
    cls, kwargs = TENSOR_STATE[case]
    preds, target = _inputs(seed=24, positive=False)
    eager = getattr(M, cls)(**kwargs, device="cpu")
    jm, tm = _jax_and_port(cls, {**kwargs, "jit_update": True})
    for p, t in _batches(preds, target):
        want = eager(_t(p), _t(t))
        got = tm(_t(p), _t(t))
        _assert(want, got, exact=True)
        _assert(jm(jnp.asarray(p), jnp.asarray(t)), got)
    for key in eager._defaults:
        _assert(getattr(eager, key), getattr(tm, key), exact=True)
    assert tm.forward_stats["launches"] == NUM_BATCHES and tm.forward_stats["demotions"] == 0


def test_explained_variance_engine_declines_the_state_that_changes_shape():
    """``ExplainedVariance(multioutput="raw_values", jit_update=True)`` on
    four (64, 3) batches: the states go from () to (3,) at the first update.

    The JAX engine's post-call check calls that state corruption, serves the
    call by ``jax.jit`` and benches the engine for a cooldown:
    ``{'dispatches': 5, 'retraces': 3, 'demotions': 1, 'last_cause':
    'state-corruption'}`` (a reference fault, ROADMAP.md Queue C). The port's
    engine declines the layout change as unsupported and the eager path
    serves every update: ``{'dispatches': 4, 'retraces': 1, 'demotions': 1,
    'last_cause': 'unsupported'}``. The values are the JAX package's."""
    rng = np.random.RandomState(25)
    jm, tm = _jax_and_port("ExplainedVariance", {"multioutput": "raw_values", "jit_update": True})
    for _ in range(4):
        p, t = rng.randn(64, 3).astype(np.float32), rng.randn(64, 3).astype(np.float32)
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(_t(p), _t(t))
    _assert_states(jm, tm)
    _assert(jm.compute(), tm.compute())
    pick = ("dispatches", "retraces", "demotions", "last_cause")
    assert {k: jm.dispatch_stats[k] for k in pick} == {
        "dispatches": 5, "retraces": 3, "demotions": 1, "last_cause": "state-corruption"}
    assert {k: tm.dispatch_stats[k] for k in pick} == {
        "dispatches": 4, "retraces": 1, "demotions": 1, "last_cause": "unsupported"}
    assert tm.dispatch_stats["permanent"] is True


# ---------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("cls,kwargs", [
    ("MeanSquaredError", {}), ("R2Score", {"num_outputs": OUTPUTS}), ("PearsonCorrCoef", {}),
    ("SpearmanCorrCoef", {}), ("TweedieDevianceScore", {"power": 2.0}),
])
def test_checkpoints_cross_between_jax_and_port(cls, kwargs):
    outputs = OUTPUTS if cls == "R2Score" else None
    preds, target = _inputs(seed=26, outputs=outputs)
    jm, tm = _jax_and_port(cls, kwargs)
    jm.persistent(True)
    tm.persistent(True)
    for p, t in _batches(preds, target)[:2]:
        jm.update(jnp.asarray(p), jnp.asarray(t))
    load_jax_state_dict(tm, jm.state_dict())
    back = getattr(J, cls)(**kwargs)
    back.load_state_dict(to_jax_state_dict(tm))
    for p, t in _batches(preds, target)[2:]:
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(_t(p), _t(t))
        back.update(jnp.asarray(p), jnp.asarray(t))
    _assert_states(jm, tm)
    _assert(jm.compute(), tm.compute())
    _assert(back.compute(), tm.compute())


def test_state_corruption_error_is_exported_and_raised_on_a_corrupt_payload():
    """``StateCorruptionError`` under the JAX package's names: the top level
    and ``metric``; a payload whose leaf no longer matches its checksum raises it."""
    import metrics_tpu_torch.metric as port_metric

    assert "StateCorruptionError" in M.__all__ and "StateCorruptionError" in J.__all__
    assert port_metric.StateCorruptionError is M.StateCorruptionError
    m = M.MeanSquaredError(device="cpu")
    m.persistent(True)
    m.update(torch.tensor([1.0, 2.0]), torch.tensor([1.5, 2.5]))
    payload = m.state_dict()
    payload["sum_squared_error"] = payload["sum_squared_error"] + 1.0
    with pytest.raises(M.StateCorruptionError, match="sum_squared_error"):
        M.MeanSquaredError(device="cpu").load_state_dict(payload)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = J.MeanSquaredError()
        jm.persistent(True)
    with pytest.raises(J.StateCorruptionError):
        jm.load_state_dict({k: (_np(v) if isinstance(v, torch.Tensor) else v) for k, v in payload.items()})
