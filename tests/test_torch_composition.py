"""Metric arithmetic (``CompositionalMetric``) of the port held against the
JAX package on the CPU.

Every operator of ``metrics_tpu/metric.py``'s ``Metric`` builds a
composition in both packages from the same dummy metrics and operands
(a Python number, a 0-d array, another metric, on either side), which then
go through ``update``, ``forward``, ``compute`` and ``reset``. Values must
be equal and of equal dtype: the operands are small integers held in
float32 or int32, so every result is exact in both (``rtol=1e-6`` is
allowed all the same, as in the other parity files).
"""
import operator
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu_torch
from metrics_tpu.metric import CompositionalMetric as JaxCompositional
from metrics_tpu_torch import CompositionalMetric, Metric
from tests.helpers.testers import DummyMetricDiff, DummyMetricSum

RTOL = 1e-6


class TorchSum(Metric):
    full_state_update = True

    def __init__(self, dtype=torch.float32):
        super().__init__(device="cpu")
        self.add_state("x", torch.tensor(0, dtype=dtype), dist_reduce_fx="sum")

    def update(self, x):
        self.x = self.x + x

    def compute(self):
        return self.x


class TorchDiff(TorchSum):
    def update(self, y):
        self.x = self.x - y


class JaxIntSum(DummyMetricSum):
    def __init__(self):
        super().__init__()
        self.x = jnp.asarray(0, dtype=jnp.int32)
        self._defaults["x"] = jnp.asarray(0, dtype=jnp.int32)


class TorchIntSum(TorchSum):
    def __init__(self):
        super().__init__(dtype=torch.int32)


def _same(jax_val, torch_val):
    ref, got = np.asarray(jax_val), torch_val.numpy()
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)


BINARY = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul, "truediv": operator.truediv,
    "floordiv": operator.floordiv, "mod": operator.mod, "pow": operator.pow,
    "lt": operator.lt, "le": operator.le, "gt": operator.gt, "ge": operator.ge, "eq": operator.eq, "ne": operator.ne,
}
BITWISE = {"and": operator.and_, "or": operator.or_, "xor": operator.xor}
UNARY = {"abs": operator.abs, "neg": operator.neg, "pos": operator.pos, "invert": operator.invert}


def _operand(kind, value, framework):
    """A Python number, or a 0-d array of it."""
    if kind == "scalar":
        return value
    return jnp.asarray(value) if framework == "jax" else torch.tensor(value)


def _drive(jax_comp, torch_comp, jax_leaves, torch_leaves, batches):
    """update, compute, forward, compute, reset on both; every value held equal."""
    jb = [jnp.asarray(b) for b in batches]
    tb = [torch.from_numpy(np.array(b)) for b in jb]  # the same values in the same dtypes
    jax_comp.update(jb[0])
    torch_comp.update(tb[0])
    _same(jax_comp.compute(), torch_comp.compute())
    _same(jax_comp(jb[1]), torch_comp(tb[1]))
    _same(jax_comp.compute(), torch_comp.compute())
    for jm, tm in zip(jax_leaves, torch_leaves):
        _same(jm.x, tm.x)
    jax_comp.reset()
    torch_comp.reset()
    for jm, tm in zip(jax_leaves, torch_leaves):
        _same(jm.x, tm.x)


@pytest.mark.parametrize("name", sorted(BINARY))
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("kind", ["scalar", "array", "metric"])
def test_binary_operators(name, side, kind):
    op = BINARY[name]
    jm, tm = DummyMetricSum(), TorchSum()
    if kind == "metric":
        jo, to = DummyMetricSum(), TorchSum()
        leaves = ([jm, jo], [tm, to])
    else:
        jo, to = _operand(kind, 3.0, "jax"), _operand(kind, 3.0, "torch")
        leaves = ([jm], [tm])
    jc, tc = (op(jm, jo), op(tm, to)) if side == "left" else (op(jo, jm), op(to, tm))
    assert isinstance(jc, JaxCompositional) and isinstance(tc, CompositionalMetric)
    _drive(jc, tc, *leaves, batches=(5.0, 2.0))


@pytest.mark.parametrize("name", sorted(BITWISE))
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("kind", ["scalar", "array", "metric"])
def test_bitwise_operators(name, side, kind):
    """Reflected ``&``, ``|`` and ``^`` keep the metric on the left in both packages."""
    op = BITWISE[name]
    jm, tm = JaxIntSum(), TorchIntSum()
    if kind == "metric":
        jo, to = JaxIntSum(), TorchIntSum()
        leaves = ([jm, jo], [tm, to])
    else:
        jo = 3 if kind == "scalar" else jnp.asarray(3, dtype=jnp.int32)
        to = 3 if kind == "scalar" else torch.tensor(3, dtype=torch.int32)
        leaves = ([jm], [tm])
    jc, tc = (op(jm, jo), op(tm, to)) if side == "left" else (op(jo, jm), op(to, tm))
    if side == "right" and kind != "metric":
        assert tc.metric_a is tm and jc.metric_a is jm
    _drive(jc, tc, *leaves, batches=(6, 5))


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_operators(name):
    op = UNARY[name]
    if name == "invert":
        jm, tm, batches = JaxIntSum(), TorchIntSum(), (6, 9)
    else:
        jm, tm, batches = DummyMetricDiff(), TorchDiff(), (3.0, -2.0)
    _drive(op(jm), op(tm), [jm], [tm], batches=batches)


def test_pos_is_abs_and_neg_is_minus_abs_as_in_the_reference():
    tm = TorchDiff()
    pos, neg = +tm, -tm
    tm.update(torch.tensor(2.0))  # the state is -2
    assert float(pos.compute()) == 2.0 and float(neg.compute()) == -2.0


@pytest.mark.parametrize("side", ["left", "right"])
def test_matmul(side):
    jm, tm = DummyMetricSum(), TorchSum()
    jv, tv = jnp.asarray([1.0, 2.0, 3.0]), torch.tensor([1.0, 2.0, 3.0])
    jc, tc = (jm @ jv, tm @ tv) if side == "left" else (jv @ (jm + jnp.zeros(3)), tv @ (tm + torch.zeros(3)))
    batches = ([2.0, 3.0, 4.0], [1.0, 0.0, 1.0])
    jm.update(jnp.asarray(batches[0]))
    tm.update(torch.tensor(batches[0]))
    _same(jc.compute(), tc.compute())


def test_getitem():
    jm, tm = DummyMetricSum(), TorchSum()
    jm.update(jnp.asarray([1.0, 2.0, 3.0]))
    tm.update(torch.tensor([1.0, 2.0, 3.0]))
    _same(jm[1].compute(), tm[1].compute())
    _same(jm[1:].compute(), tm[1:].compute())


# ---------------------------------------------- tests/bases/test_composition.py
def test_sub_and_div():
    a, b = TorchSum(), TorchDiff()
    sub, div = a - b, a / 2.0
    a.update(torch.tensor(6.0))
    b.update(torch.tensor(2.0))
    assert float(sub.compute()) == 8.0 and float(div.compute()) == 3.0


def test_metrics_composed_of_metrics_and_nested():
    a, b = TorchSum(), TorchSum()
    mean = (a + b) / 2
    nested = ((a + 1) * 2) - 1
    a.update(torch.tensor(4.0))
    b.update(torch.tensor(2.0))
    assert float(mean.compute()) == 3.0 and float(nested.compute()) == 9.0


def test_compositional_forward_updates_both_leaves():
    a, b = TorchSum(), TorchSum()
    assert float((a + b)(torch.tensor(2.0))) == 4.0
    assert float(a.x) == 2.0 and float(b.x) == 2.0


def test_compositional_reset_and_update():
    a = TorchSum()
    comp = a + 1.0
    comp.update(torch.tensor(2.0))
    assert float(comp.compute()) == 3.0
    comp.reset()
    assert float(a.x) == 0.0


def test_composition_kwarg_routing():
    """Each operand's update gets the kwargs it accepts."""

    class KwargMean(metrics_tpu.MeanMetric):
        def update(self, special_value):  # noqa: D102
            super().update(special_value)

    class TorchKwargMean(metrics_tpu_torch.MeanMetric):
        def update(self, special_value):  # noqa: D102
            super().update(special_value)

    jc = KwargMean() + metrics_tpu.MeanMetric()
    tc = TorchKwargMean(device="cpu") + metrics_tpu_torch.MeanMetric(device="cpu")
    jc.update(special_value=jnp.asarray(2.0), value=jnp.asarray(4.0))
    tc.update(special_value=torch.tensor(2.0), value=torch.tensor(4.0))
    _same(jc.compute(), tc.compute())
    assert float(tc.compute()) == 6.0


def test_composition_pickles_and_clones_at_depth():
    a, b = TorchSum(), TorchSum()
    combo = abs((a + b) * 2 - 1) ** 2
    a.update(torch.tensor(1.0))
    b.update(torch.tensor(2.0))
    assert float(combo.compute()) == 25.0
    assert float(pickle.loads(pickle.dumps(combo)).compute()) == 25.0
    assert float(combo.clone().compute()) == 25.0
    assert float(pickle.loads(pickle.dumps(-a)).compute()) == -1.0
    assert "CompositionalMetric" in repr(combo) and "TorchSum()" in repr(combo)


def test_composition_state_dict_reaches_the_operands():
    """``state_dict``/``load_state_dict``, ``persistent``, ``to`` and
    ``set_dtype`` recurse into the operand metrics, with the JAX package's keys."""
    ja, jb, ta, tb = DummyMetricSum(), DummyMetricSum(), TorchSum(), TorchSum()
    jc, tc = ja * jb, ta * tb
    jc.persistent(True)
    tc.persistent(True)
    for m, v in ((ja, 2.0), (jb, 3.0)):
        m.update(jnp.asarray(v))
    for m, v in ((ta, 2.0), (tb, 3.0)):
        m.update(torch.tensor(v))
    jsd, tsd = jc.state_dict(), tc.state_dict()
    assert sorted(jsd) == sorted(tsd) == sorted(
        ["metric_a.x", "metric_b.x", "__checksum__::metric_a.x", "__checksum__::metric_b.x"]
    )
    assert {k: v for k, v in jsd.items() if k.startswith("__checksum__")} == {
        k: v for k, v in tsd.items() if k.startswith("__checksum__")
    }
    fresh = TorchSum() * TorchSum()
    fresh.load_state_dict(jsd)
    assert float(fresh.compute()) == 6.0
    fresh.to("cpu").set_dtype(torch.float64)
    assert fresh.metric_a.x.dtype == torch.float64 and fresh.compute().dtype == torch.float64


def test_composition_lives_on_its_operands_device_and_holds_no_state():
    scaled = 2 * TorchSum()
    assert scaled.device == torch.device("cpu") and scaled._defaults == {}
    assert scaled.metric_a.dtype == torch.int32 and scaled.metric_a.device.type == "cpu"


def test_equality_builds_a_metric_and_metrics_do_not_iterate():
    """``==`` composes (a truthy metric), so metrics compare by identity; a
    metric is not iterable, where ``__getitem__`` alone would loop for ever."""
    a, b = TorchSum(), TorchSum()
    assert isinstance(a == b, CompositionalMetric)
    with pytest.raises(TypeError):
        iter(a)
    with pytest.raises(TypeError):
        list(a)
    with pytest.raises(TypeError):
        _ = 1.0 in a
    assert hash(a) != hash(b) and len({a, b}) == 2


def test_metric_core_dtype_state_and_memory_helpers_match_the_jax_package():
    """``float``/``double``/``half``/``type`` change nothing; ``set_dtype``
    casts floating states (and their defaults) only; ``state()`` is a copy;
    ``memory_snapshot`` reports what the JAX package reports."""
    jm, tm = DummyMetricSum(), TorchSum()
    ja, ta = metrics_tpu.Accuracy(num_classes=3, average="macro"), metrics_tpu_torch.Accuracy(
        num_classes=3, average="macro", device="cpu")
    for m in (tm, ta):
        assert m.float() is m and m.double() is m and m.half() is m and m.type(torch.float64) is m
    assert tm.x.dtype == torch.float32
    jm.set_dtype(jnp.float16)
    ja.set_dtype(jnp.float16)
    assert tm.set_dtype(torch.float16) is tm and ta.set_dtype(torch.float16) is ta
    assert tm.memory_snapshot() == jm.memory_snapshot() and ta.memory_snapshot() == ja.memory_snapshot()
    assert tm.x.dtype == tm._defaults["x"].dtype == torch.float16 and ta.tp.dtype == torch.int32
    tm.update(torch.tensor(2.0, dtype=torch.float16))
    tm.reset()
    assert tm.x.dtype == torch.float16  # the default was cast too
    state = tm.state()
    state["x"] += 1
    assert float(tm.x) == 0.0
