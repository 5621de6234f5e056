"""The port's fused forward held against the JAX package on the CPU.

The counterpart of ``tests/bases/test_fused_forward.py`` and the forward cases
of ``tests/bases/test_fused_collection.py``. The same seeded numpy inputs go
through both packages' ``forward`` with the engine on (``jit_update=True``, or
``fused_update=True`` for a collection). Batch values must equal the JAX
package's to ``rtol=1e-6`` (float32 in both, computed in another order), the
integer states exactly, and ``forward_stats`` must count the same
``launches`` and ``retraces``, for both program shapes: one update merged by
the reductions (``full_state_update=False``) and two updates
(``full_state_update=True``). A value returned by one step keeps its values
after the next step.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu_torch
from metrics_tpu.metric import Metric as JaxMetric
from metrics_tpu_torch import Metric, MetricCollection

RTOL = 1e-6
C = 6
SIZES = (64, 64, 48, 65, 100, 2)


def _pair(rng, b, c=C):
    preds = rng.rand(b, c).astype(np.float32)
    target = rng.randint(0, c, b).astype(np.int32)
    return (jnp.asarray(preds), jnp.asarray(target)), (torch.from_numpy(preds), torch.from_numpy(target))


def _counts(stats):
    return {k: stats[k] for k in ("launches", "retraces")}


class _JaxRunningMax(JaxMetric):
    full_state_update = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("value", jnp.asarray(-jnp.inf), dist_reduce_fx="max")

    def update(self, values):
        self.value = jnp.maximum(self.value, jnp.max(values))

    def compute(self):
        return self.value


class _RunningMax(Metric):
    full_state_update = True

    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("value", torch.tensor(-float("inf")), dist_reduce_fx="max")

    def update(self, values):
        self.value = torch.maximum(self.value, torch.max(values))

    def compute(self):
        return self.value


class _JaxMeanState(JaxMetric):
    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("v", jnp.asarray(0.0), dist_reduce_fx="mean")

    def update(self, x, target=None):
        self.v = jnp.mean(x)

    def compute(self):
        return self.v


class _MeanState(Metric):
    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("v", torch.tensor(0.0), dist_reduce_fx="mean")

    def update(self, x, target=None):
        self.v = torch.mean(x)

    def compute(self):
        return self.v


@pytest.mark.parametrize("average", ["micro", "macro"])
def test_forward_values_equal_jax_one_update_merged(average):
    rng = np.random.RandomState(0)
    jm = metrics_tpu.Accuracy(num_classes=C, average=average, jit_update=True)
    tm = metrics_tpu_torch.Accuracy(num_classes=C, average=average, jit_update=True, device="cpu")
    assert tm.full_state_update is False
    for b in SIZES:
        (jp, jt), (tp, tt) = _pair(rng, b)
        np.testing.assert_allclose(tm(tp, tt).numpy(), np.asarray(jm(jp, jt)), rtol=RTOL)
    for k in tm._defaults:
        assert np.array_equal(getattr(tm, k).numpy(), np.asarray(getattr(jm, k)))
    np.testing.assert_allclose(tm.compute().numpy(), np.asarray(jm.compute()), rtol=RTOL)
    # 64 builds the 64-row program, 48 shares it, 65 and 100 the 128-row one, 2 the 8-row one
    assert _counts(tm.forward_stats) == _counts(jm.forward_stats) == {"launches": 6, "retraces": 3}
    assert tm.dispatch_stats["dispatches"] == 0  # the step is the program: no update rides along


def test_forward_values_equal_jax_two_updates():
    rng = np.random.RandomState(1)
    jm, tm = _JaxRunningMax(jit_update=True), _RunningMax(jit_update=True)
    eager = _RunningMax()
    for _ in range(4):
        x = rng.randn(17).astype(np.float32)
        got = tm(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jm(jnp.asarray(x))))
        assert torch.equal(got, eager(torch.from_numpy(x)))
    assert torch.equal(tm.value, eager.value)
    assert _counts(tm.forward_stats) == _counts(jm.forward_stats) == {"launches": 4, "retraces": 1}


def test_a_step_value_keeps_its_values_after_the_next_step():
    rng = np.random.RandomState(2)
    tm = metrics_tpu_torch.Accuracy(num_classes=C, average="none", jit_update=True, device="cpu")
    eager = metrics_tpu_torch.Accuracy(num_classes=C, average="none", device="cpu")
    steps = []
    for b in (32, 32, 20):
        _, (tp, tt) = _pair(rng, b)
        steps.append((tm(tp, tt), eager(tp, tt).clone()))
    for got, want in steps:
        assert torch.equal(got, want)


def test_mean_state_merges_with_the_running_count():
    rng = np.random.RandomState(3)
    jm, tm = _JaxMeanState(jit_update=True), _MeanState(jit_update=True)
    eager = _MeanState()
    for _ in range(4):
        x = rng.rand(8).astype(np.float32)
        got = tm(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(jm(jnp.asarray(x))), rtol=RTOL)
        torch.testing.assert_close(got, eager(torch.from_numpy(x)), rtol=RTOL, atol=0)
    np.testing.assert_allclose(tm.v.numpy(), np.asarray(jm.v), rtol=RTOL)
    assert tm.forward_stats["retraces"] == 1  # the growing count is an input, not a key


def test_kill_switch_takes_the_eager_branches(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_FUSED_FORWARD", "0")
    rng = np.random.RandomState(4)
    tm = metrics_tpu_torch.Accuracy(num_classes=C, average="macro", jit_update=True, device="cpu")
    eager = metrics_tpu_torch.Accuracy(num_classes=C, average="macro", device="cpu")
    for b in (16, 9):
        _, (tp, tt) = _pair(rng, b)
        assert torch.equal(tm(tp, tt), eager(tp, tt))
    assert tm.forward_stats["launches"] == 0
    # the eager branches' updates still go through the update engine, on copies of its buffers
    assert tm.dispatch_stats["dispatches"] == 2
    for k in tm._defaults:
        assert torch.equal(getattr(tm, k), getattr(eager, k))


def test_eager_metrics_and_list_states_never_engage_the_engine():
    rng = np.random.RandomState(5)
    _, (tp, tt) = _pair(rng, 16)
    plain = metrics_tpu_torch.Accuracy(num_classes=C, device="cpu")
    plain(tp, tt)
    assert plain._dispatcher is None and plain.forward_stats["launches"] == 0
    cat = metrics_tpu_torch.CatMetric(jit_update=True, device="cpu")
    assert torch.equal(cat(torch.tensor([1.0, 2.0])), torch.tensor([1.0, 2.0]))
    assert cat._dispatcher is None and cat.forward_stats["launches"] == 0


def test_engine_forward_survives_pickle_and_reset():
    import pickle

    rng = np.random.RandomState(6)
    _, (tp, tt) = _pair(rng, 24)
    tm = metrics_tpu_torch.Accuracy(num_classes=C, average="macro", jit_update=True, device="cpu")
    first = tm(tp, tt)
    revived = pickle.loads(pickle.dumps(tm))
    assert torch.equal(revived(tp, tt), first)
    tm.reset()
    assert torch.equal(tm(tp, tt), first)


def _members(pkg, **kw):
    macro = dict(num_classes=C, average="macro", **kw)
    mm = dict(update_method="matmul", **kw) if pkg is metrics_tpu_torch else {}
    return [pkg.Accuracy(**macro), pkg.Precision(**macro), pkg.Recall(**macro), pkg.F1Score(**macro),
            pkg.FBetaScore(beta=0.5, **macro), pkg.Specificity(**macro), pkg.HammingDistance(**kw),
            pkg.ConfusionMatrix(C, **mm), pkg.CohenKappa(C, weights="quadratic", **mm),
            pkg.MatthewsCorrCoef(C, **mm), pkg.JaccardIndex(C, **mm)]


def test_fused_collection_forward_equals_jax_fused_and_eager():
    rng = np.random.RandomState(7)
    jc = metrics_tpu.MetricCollection(_members(metrics_tpu), prefix="val_", fused_update=True)
    tc = MetricCollection(_members(metrics_tpu_torch, device="cpu"), prefix="val_", fused_update=True)
    eager = MetricCollection(_members(metrics_tpu_torch, device="cpu"), prefix="val_", fused_update=False)
    for b in (16, 16, 9):
        (jp, jt), (tp, tt) = _pair(rng, b)
        jv, tv, ev = jc(jp, jt), tc(tp, tt), eager(tp, tt)
        assert set(tv) == set(jv) == set(ev)
        for k in jv:
            np.testing.assert_allclose(tv[k].numpy(), np.asarray(jv[k]), rtol=RTOL, atol=2.0**-23)
            assert torch.equal(tv[k], ev[k]), k
    for name, m in tc.items(keep_base=True):
        for k in m._defaults:
            assert np.array_equal(getattr(m, k).numpy(), np.asarray(getattr(jc[name], k))), (name, k)
            assert torch.equal(getattr(m, k), getattr(eager[name], k))
    assert _counts(tc.forward_stats) == _counts(jc.forward_stats) == {"launches": 3, "retraces": 2}
    for k, v in tc.compute().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jc.compute()[k]), rtol=RTOL, atol=2.0**-23)


def test_fused_collection_forward_masks_and_merges_mean_states():
    rng = np.random.RandomState(8)
    jc = metrics_tpu.MetricCollection({"acc": metrics_tpu.Accuracy(num_classes=C, average="macro"),
                                       "m": _JaxMeanState()}, fused_update=True)
    tc = MetricCollection({"acc": metrics_tpu_torch.Accuracy(num_classes=C, average="macro", device="cpu"),
                           "m": _MeanState()}, fused_update=True)
    for b in (12, 16, 5):
        (jp, jt), (tp, tt) = _pair(rng, b)
        jv, tv = jc(jp, jt), tc(tp, tt)
        for k in jv:
            np.testing.assert_allclose(tv[k].numpy(), np.asarray(jv[k]), rtol=RTOL)
    np.testing.assert_allclose(tc["m"].v.numpy(), np.asarray(jc["m"].v), rtol=RTOL)
    assert _counts(tc.forward_stats) == _counts(jc.forward_stats)
