"""The port's resilience policy and fault injection held against the JAX package on the CPU.

The counterpart of the engine cases of ``tests/bases/test_chaos.py``. Each
fault is injected through the real injection points of both packages'
engines, on the same seeded inputs. Every call must still be served (by the
eager path): the state and value must equal a run with no fault bit for bit
(float32 sums of the same values in the same order: exact), the demotion
must be recorded with the JAX package's cause tag, and the engine must come
back after the documented cooldown.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu_torch
from metrics_tpu import faults as jax_faults
from metrics_tpu import resilience as jax_resilience
from metrics_tpu.metric import Metric as JaxMetric
from metrics_tpu_torch import Metric, MetricCollection, faults, resilience
from metrics_tpu_torch.utilities.exceptions import StateCorruptionError

EXPECTED_CAUSE = {
    "compile": "injected:compile",
    "launch": "injected:launch",
    "oom": "injected:oom",
    "nan-input": "state-corruption",
    "state-corruption": "state-corruption",
}


class _JaxFloatSum(JaxMetric):
    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", jnp.asarray(0.0), dist_reduce_fx="sum")

    def update(self, values):
        self.total = self.total + jnp.sum(values)

    def compute(self):
        return self.total


class _FloatSum(Metric):
    """A float state, so that NaN-poisoned inputs reach it and the
    verification that runs while a fault is active sees them."""

    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, values):
        self.total = self.total + torch.sum(values)

    def compute(self):
        return self.total


def _batches(n=3, size=8):
    rng = np.random.RandomState(11)
    return [rng.rand(size).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("fault", sorted(EXPECTED_CAUSE))
def test_update_fault_degrades_to_eager_parity(fault):
    batches = _batches()
    ref = _FloatSum()
    for v in batches:
        ref.update(torch.from_numpy(v))
    jm, tm = _JaxFloatSum(jit_update=True), _FloatSum(jit_update=True)
    with jax_faults.inject(fault) as jspec:
        for v in batches:
            jm.update(jnp.asarray(v))
    with faults.inject(fault) as spec:
        for v in batches:
            tm.update(torch.from_numpy(v))
    assert spec.fired >= 1 and jspec.fired >= 1
    assert torch.equal(tm.total, ref.total) and torch.isfinite(tm.total)
    np.testing.assert_array_equal(tm.total.numpy(), np.asarray(jm.total))
    stats, jstats = tm.dispatch_stats, jm.dispatch_stats
    assert stats["last_cause"] == jstats["last_cause"] == EXPECTED_CAUSE[fault]
    assert stats["demotions"] >= 1 and not stats["permanent"]
    assert {k: stats[k] for k in ("demotions", "cooldown")} == {k: jstats[k] for k in ("demotions", "cooldown")}


@pytest.mark.parametrize("fault", ["launch", "nan-input", "state-corruption"])
def test_forward_fault_degrades_to_eager_parity(fault):
    batches = _batches()
    ref = _FloatSum(jit_update=True)
    want = [ref(torch.from_numpy(v)) for v in batches]
    tm = _FloatSum(jit_update=True)
    with faults.inject(fault) as spec:
        got = [tm(torch.from_numpy(v)) for v in batches]
    assert spec.fired >= 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(tm.total, ref.total) and torch.equal(tm.compute(), ref.compute())
    assert tm.forward_stats["last_cause"] == EXPECTED_CAUSE[fault]
    assert tm.forward_stats["demotions"] >= 1 and not tm.forward_stats["permanent"]


def test_a_launch_fault_restores_state_degrades_and_repromotes_after_the_cooldown():
    """One launch fault costs exactly the documented cooldown (4 eager calls),
    then the engine is tried again and promoted; counted as the JAX package counts."""
    v = np.asarray([1.0, 2.0], np.float32)
    jm, tm = _JaxFloatSum(jit_update=True), _FloatSum(jit_update=True)
    tm.update(torch.from_numpy(v))  # a program is built and holds the state
    jm.update(jnp.asarray(v))
    held = tm.total
    with faults.inject("launch", count=1) as spec, jax_faults.inject("launch", count=1):
        tm.update(torch.from_numpy(v))
        jm.update(jnp.asarray(v))
    assert spec.fired == 1 and float(tm.total) == 6.0 and float(held) == 3.0
    assert tm.dispatch_stats["cooldown"] == jm.dispatch_stats["cooldown"] == 4
    dispatches = tm._dispatch_stats["dispatches"]
    for _ in range(4):
        tm.update(torch.from_numpy(v))
        jm.update(jnp.asarray(v))
    assert tm.dispatch_stats["cooldown"] == 0 and tm._dispatcher.stats["dispatches"] == dispatches + 4
    tm.update(torch.from_numpy(v))
    jm.update(jnp.asarray(v))
    for key in ("demotions", "repromotions", "cooldown", "permanent", "last_cause"):
        assert tm.dispatch_stats[key] == jm.dispatch_stats[key], key
    assert tm.dispatch_stats["repromotions"] == 1 and float(tm.compute()) == 7 * 3.0
    np.testing.assert_array_equal(tm.total.numpy(), np.asarray(jm.total))


def test_a_failure_after_the_program_ran_restores_the_state_before_it():
    """State corruption found after the program ran: the snapshot (the leaves
    by reference) is restored, and the eager path serves the call."""
    tm = _FloatSum(jit_update=True)
    tm.update(torch.tensor([1.0]))
    before = tm.total
    with faults.inject("state-corruption", count=1):
        tm.update(torch.tensor([2.0]))
    assert float(before) == 1.0 and float(tm.total) == 3.0
    snap = resilience.snapshot_state(tm)
    assert snap["leaves"]["total"] is tm.total and snap["update_count"] == 2
    assert "update_count" not in resilience.snapshot_state(tm, counters=False)


def test_backoff_schedule_doubles_and_caps_as_in_jax():
    p, jp = resilience.ResiliencePolicy(), jax_resilience.ResiliencePolicy()
    for policy in (p, jp):
        assert policy.allow()
        assert policy.note_failure("boom") == 4
        for _ in range(4):
            assert not policy.allow()
        assert policy.allow()
        assert policy.note_failure("boom") == 8
        policy.failures = 20
        assert policy.note_failure("boom") == 256
        policy.note_success()
    assert p.stats() == jp.stats() and p.allow() and not p.blocked


def test_resilience_kill_switch_demotes_for_good(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_RESILIENCE", "0")
    tm = _FloatSum(jit_update=True)
    with faults.inject("launch", count=1):
        tm.update(torch.tensor([1.0]))
    assert tm.dispatch_stats["permanent"] and tm._dispatcher is None
    tm.update(torch.tensor([1.0]))
    assert float(tm.compute()) == 2.0


def test_env_var_fault_activation(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_INJECT_FAULT", "launch")
    assert faults.any_active()
    tm = _FloatSum(jit_update=True)
    tm.update(torch.tensor([1.0, 2.0]))
    assert tm.dispatch_stats["demotions"] == 1 and tm.dispatch_stats["last_cause"] == "injected:launch"
    assert float(tm.compute()) == 3.0
    assert faults.fired_count("launch") >= 1


def test_fault_api_matches_jax():
    assert not faults.any_active() and not faults.should_fire("launch")
    with faults.inject("launch", count=2) as spec:
        assert faults.any_active()
        assert faults.should_fire("launch") and faults.should_fire("launch") and not faults.should_fire("launch")
        assert spec.fired == faults.fired_count("launch") == 2
    with faults.inject("compile"):
        with pytest.raises(faults.InjectedFault, match="injected fault: compile") as err:
            faults.check("compile", "here")
    jax_cause = jax_resilience.classify(jax_faults.InjectedFault("compile"))
    assert resilience.classify(err.value) == jax_cause == "injected:compile"
    assert resilience.classify(StateCorruptionError("x")) == "state-corruption"
    with faults.inject("oom", cap=100):
        faults.check_oom(100)
        with pytest.raises(faults.InjectedFault, match="oom"):
            faults.check_oom(101)
    with faults.inject("nan-input"):
        poisoned = faults.maybe_poison([torch.ones(3), torch.ones(3, dtype=torch.int32)])
    assert torch.isnan(poisoned[0]).all() and torch.equal(poisoned[1], torch.ones(3, dtype=torch.int32))
    with faults.inject("state-corruption", leaf=1):
        bad = faults.maybe_corrupt_leaves((torch.zeros(2), torch.zeros(2)))
    assert bad[1].shape == (3, 7) and bad[0].shape == (2,)


@pytest.mark.parametrize("name,kwargs", [("QuantileSketch", dict(bins=64)), ("HyperLogLog", dict(precision=5)),
                                         ("CountMinHeavyHitters", dict(depth=2, width=64))])
def test_sketch_launch_fault_degrades_to_eager_parity(name, kwargs):
    batches = [torch.from_numpy(v * 100) for v in _batches(n=6)]
    ref = getattr(metrics_tpu_torch, name)(device="cpu", **kwargs)
    tm = getattr(metrics_tpu_torch, name)(jit_update=True, device="cpu", **kwargs)
    with faults.inject("launch") as spec:
        for v in batches:
            ref.update(v)
            tm.update(v)
    assert spec.fired >= 1
    for k in ref._defaults:
        assert torch.equal(getattr(tm, k), getattr(ref, k))
    assert tm.dispatch_stats["demotions"] >= 1 and not tm.dispatch_stats["permanent"]


def _collection(pkg, **kw):
    c = 5
    return [pkg.Accuracy(num_classes=c, average="macro", **kw), pkg.HammingDistance(**kw)]


@pytest.mark.parametrize("fault", ["compile", "launch", "state-corruption"])
def test_fused_collection_fault_restores_and_serves_eagerly(fault):
    rng = np.random.RandomState(12)
    batches = [(rng.rand(b, 5).astype(np.float32), rng.randint(0, 5, b).astype(np.int32)) for b in (9, 12, 9)]
    jc = metrics_tpu.MetricCollection(_collection(metrics_tpu), fused_update=True)
    tc = MetricCollection(_collection(metrics_tpu_torch, device="cpu"), fused_update=True)
    ref = MetricCollection(_collection(metrics_tpu_torch, device="cpu"), fused_update=False)
    with faults.inject(fault, count=1), jax_faults.inject(fault, count=1), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # an explicit fused_update=True warns of the fallback
        for p, t in batches:
            jc.update(jnp.asarray(p), jnp.asarray(t))
            tc.update(torch.from_numpy(p), torch.from_numpy(t))
            ref.update(torch.from_numpy(p), torch.from_numpy(t))
    for name, m in tc.items(keep_base=True):
        for k in m._defaults:
            assert torch.equal(getattr(m, k), getattr(ref[name], k)), (name, k)
            np.testing.assert_array_equal(getattr(m, k).numpy(), np.asarray(getattr(jc[name], k)))
    stats, jstats = tc.dispatch_stats, jc.dispatch_stats
    assert stats["demotions"] == jstats["demotions"] == 1 and stats["last_cause"] == jstats["last_cause"]
    assert not tc._fuse_failed and stats["cooldown"] == jstats["cooldown"]
