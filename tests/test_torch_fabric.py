"""The port's serving fabric (metrics_tpu_torch/fabric.py) against the JAX package's.

Every stream goes through ``metrics_tpu.fabric.ShardedMetricsService`` and the
port's in one process, from the same numpy inputs. They must agree on each
shard's ``state_digest`` (the numpy bytes of its sessions' rows), on every
value (counts exactly, floats to rtol 1e-6), on the fabric's ``stats`` and
failover events, and on the serving and fabric spans counted by name and
kind. The behaviours of ``tests/bases/test_fabric.py`` are held here: the
ring, routing parity with one service, shard-local submits, the rid
lattice, tenant overrides across failover, fence-then-replay failover, the
``shard-death`` fault, per-shard queue bounds, the fleet snapshot and
``forward`` through the fabric. The helpers here serve the other
``tests/test_torch_fabric_*.py`` and ``test_torch_fleet_read.py`` files.
"""
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu_torch
from metrics_tpu import fabric as jfabric
from metrics_tpu_torch import faults, telemetry
from metrics_tpu_torch.fabric import HashRing, ShardDeadError, ShardedMetricsService, StaleEpochError
from metrics_tpu_torch.serve import MetricsService, QueueFullError

C = 8
TEMPLATES = {
    "acc8": (lambda: metrics_tpu_torch.Accuracy(task="multiclass", num_classes=C, device="cpu"),
             lambda: metrics_tpu.Accuracy(task="multiclass", num_classes=C)),
    "macro8": (lambda: metrics_tpu_torch.Accuracy(num_classes=C, average="macro", device="cpu"),
               lambda: metrics_tpu.Accuracy(num_classes=C, average="macro")),
    "mean": (lambda: metrics_tpu_torch.MeanMetric(device="cpu"), lambda: metrics_tpu.MeanMetric()),
    "mean_int8": (lambda: metrics_tpu_torch.MeanMetric(sync_precision="int8", device="cpu"),
                  lambda: metrics_tpu.MeanMetric(sync_precision="int8")),
    "countmin": (lambda: metrics_tpu_torch.CountMinHeavyHitters(depth=4, width=64, device="cpu"),
                 lambda: metrics_tpu.CountMinHeavyHitters(depth=4, width=64)),
}
# what both packages' fabrics and services emit (the engines' own spans differ by design)
FABRIC_SPANS = {"update", "compile", "request", "journal", "checkpoint", "degrade", "read", "collective", "failover",
                "handoff", "membership", "replicate", "anti-entropy", "suspect"}


def to_torch(x):
    return torch.from_numpy(np.asarray(x)) if isinstance(x, np.ndarray) else x


def to_jax(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def as_numpy(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def close(got, want):
    got, want = as_numpy(got), as_numpy(want)
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)


def values_close(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        close(got[name], want[name])


def digests(values):
    return {k: as_numpy(v).tobytes() for k, v in values.items()}


def span_counts(session, names=FABRIC_SPANS):
    return Counter((e.name, e.kind) for e in session.events if e.name in names)


class FabPair:
    """One fabric of each package, over the same template and options, each
    with its own data directory."""

    def __init__(self, tmp_path=None, num_shards=3, template="acc8", **kwargs):
        make_t, make_j = TEMPLATES[template]
        self.make_t, self.make_j = make_t, make_j
        self.t = ShardedMetricsService(make_t(), num_shards=num_shards,
                                       data_dir=None if tmp_path is None else str(tmp_path / "torch"), **kwargs)
        self.j = jfabric.ShardedMetricsService(make_j(), num_shards=num_shards,
                                               data_dir=None if tmp_path is None else str(tmp_path / "jax"),
                                               **kwargs)

    def both(self, op, *args, **kwargs):
        """One operation on both fabrics: (the port's result, the JAX package's)."""
        return (getattr(self.t, op)(*(to_torch(a) for a in args), **kwargs),
                getattr(self.j, op)(*(to_jax(a) for a in args), **kwargs))

    def submit(self, name, *arrays, **kwargs):
        return self.both("submit", name, *arrays, **kwargs)

    def feed(self, ops, drain=True):
        for name, *arrays in ops:
            self.submit(name, *arrays)
        if drain:
            self.both("drain")

    def shard_digests(self):
        """Per serving shard: (id, digest, epoch, host, alive, retired), both packages."""
        def of(fab):
            return [(s.shard_id, s.service.state_digest(), s.epoch, s.host, s.alive, s.retired)
                    for s in fab._shards if not s.retired]
        return of(self.t), of(self.j)

    def check(self, values=True):
        t_shards, j_shards = self.shard_digests()
        assert t_shards == j_shards
        assert self.t.stats == self.j.stats
        assert [dict(e, ms=None) for e in self.t.failover_events] == [dict(e, ms=None) for e in self.j.failover_events]
        if values:
            got, want = self.both("compute_all")
            values_close(got, want)
            return got, want
        return None

    def shutdown(self):
        self.both("shutdown")


def instrumented(fn):
    """Run ``fn`` inside one session of each package: (port session, JAX session)."""
    with telemetry.instrument() as ts, metrics_tpu.telemetry.instrument() as js:
        fn()
    return ts, js


def batches(n, steps=2, batch=16, seed=0):
    """``{name: [(preds, target), ...]}`` of label batches."""
    rng = np.random.RandomState(seed)
    return {f"t{i}": [(rng.randint(0, C, batch), rng.randint(0, C, batch)) for _ in range(steps)] for i in range(n)}


def stream(n_sessions=18, ops=3, batch=16, seed=0):
    """A round-robin op stream ``[(name, preds, target)]`` and its names."""
    rng = np.random.RandomState(seed)
    names = [f"t{i}" for i in range(n_sessions)]
    out = []
    for _ in range(ops):
        for name in names:
            out.append((name, rng.randint(0, C, batch), rng.randint(0, C, batch)))
    return names, out


def control(ops, template="acc8"):
    """One unsharded port service fed ``ops``: its values' bytes."""
    ref = MetricsService(TEMPLATES[template][0]())
    for name, *arrays in ops:
        ref.submit(name, *(to_torch(a) for a in arrays))
    ref.drain()
    out = digests(ref.compute_all())
    ref.shutdown()
    return out


# --------------------------------------------------------------------- ring
def test_ring_is_deterministic_total_and_the_jax_packages():
    a, b, j = HashRing([0, 1, 2, 3]), HashRing([0, 1, 2, 3]), jfabric.HashRing([0, 1, 2, 3])
    names = [f"session-{i}" for i in range(500)]
    assert [a.owner(n) for n in names] == [b.owner(n) for n in names] == [j.owner(n) for n in names]
    spread = a.spread(names)
    assert spread == j.spread(names) and all(v > 0 for v in spread.values())
    for vnodes in (1, 8, 64):
        assert ([HashRing([0, 2, 5], vnodes).owner(n) for n in names]
                == [jfabric.HashRing([0, 2, 5], vnodes).owner(n) for n in names])


def test_ring_successor_and_arc_losers_match_the_jax_package():
    ring, jring = HashRing([0, 1, 2, 3]), jfabric.HashRing([0, 1, 2, 3])
    for sid in range(4):
        assert ring.successor(sid) == jring.successor(sid) != sid
    assert ring.successor(1, alive=[2]) == 2
    with pytest.raises(ShardDeadError, match="fleet dead"):
        ring.successor(1, alive=[1])
    bigger, jbigger = HashRing([0, 1, 2, 3, 4]), jfabric.HashRing([0, 1, 2, 3, 4])
    assert ring.arc_losers(bigger) == jring.arc_losers(jbigger) and ring.arc_losers(bigger)
    with pytest.raises(ValueError):
        HashRing([])


# ---------------------------------------------------------- routing parity
def test_fabric_parity_with_one_service_and_the_jax_fabric():
    data = batches(12)
    pair = FabPair(num_shards=3)
    ref = MetricsService(TEMPLATES["acc8"][0]())
    for name, steps in data.items():
        for p, t in steps:
            pair.submit(name, p, t)
            ref.submit(name, to_torch(p), to_torch(t))
    pair.both("drain")
    ref.drain()
    got, _ = pair.check()
    assert digests(got) == digests(ref.compute_all())
    assert [pair.t.shard_for(n) for n in data] == [pair.j.shard_for(n) for n in data]
    pair.shutdown()


def test_submit_is_shard_local_and_collective_free():
    data = batches(9)
    pair = FabPair(num_shards=3)
    before = sum(v for k, v in telemetry.snapshot().items() if k.startswith("collective"))

    def run():
        for name, steps in data.items():
            for p, t in steps:
                pair.submit(name, p, t)
        pair.both("drain")

    ts, js = instrumented(run)
    assert sum(v for k, v in telemetry.snapshot().items() if k.startswith("collective")) == before
    assert span_counts(ts) == span_counts(js)
    owners = {e.owner for e in ts.spans(name="update", kind="stacked-aot")}
    assert owners and all("@shard" in o for o in owners)
    assert {int(o.rsplit("@shard", 1)[1]) for o in owners} == {pair.t.shard_for(n) for n in data}
    pair.shutdown()


def test_rid_lattice_is_disjoint_across_shards():
    data = batches(9, steps=3)
    pair = FabPair(num_shards=3)
    for name, steps in data.items():
        for p, t in steps:
            pair.submit(name, p, t)
    pair.both("drain")
    heads = [(s.shard_id, s.service._rid) for s in pair.t._shards]
    assert heads == [(s.shard_id, s.service._rid) for s in pair.j._shards]
    assert all(rid % 3 == sid for sid, rid in heads)
    pair.shutdown()


# ------------------------------------------------------- per-tenant config
def test_tenant_config_routes_and_survives_failover(tmp_path):
    data = batches(8)
    pair = FabPair(tmp_path, num_shards=2)
    loud = next(iter(data))
    pair.both("configure_session", loud, admission="reject")
    shard = pair.t.shard_for(loud)
    for name, steps in data.items():
        for p, t in steps:
            pair.submit(name, p, t)
    pair.both("drain")
    pair.both("checkpoint")
    pair.both("kill_shard", shard)
    pair.both("fail_over", shard)
    assert pair.t._shards[shard].service.session_config(loud)["admission"] == "reject"
    assert pair.j._shards[shard].service.session_config(loud)["admission"] == "reject"
    pair.check()
    pair.shutdown()


# ----------------------------------------------------------------- failover
def test_shard_death_failover_is_bit_identical_and_fences_the_zombie(tmp_path):
    data = batches(10, steps=3)
    pair = FabPair(tmp_path, num_shards=3)
    for name, steps in data.items():
        for p, t in steps:
            pair.submit(name, p, t)
    pair.both("drain")
    pair.both("checkpoint")
    want = control([(n, p, t) for n, steps in data.items() for p, t in steps])
    victim = pair.t.shard_for(next(iter(data)))
    zombie, _ = pair.both("kill_shard", victim)
    ms, jms = pair.both("fail_over", victim)
    assert ms >= 0.0 and jms >= 0.0
    got, _ = pair.check()
    assert digests(got) == want
    assert pair.t.stats["failovers"] == 1 and pair.t.failover_events[0]["shard"] == victim
    assert pair.t._shards[victim].epoch > zombie.epoch
    name = next(n for n in data if pair.t.shard_for(n) == victim)
    with pytest.raises(StaleEpochError):
        zombie.submit(name, *(to_torch(a) for a in data[name][0]))
    with pytest.raises(StaleEpochError):
        zombie.checkpoint()
    pair.shutdown()


def test_auto_failover_serves_through_death(tmp_path):
    data = batches(6)
    pair = FabPair(tmp_path, num_shards=2)
    for name, steps in data.items():
        for p, t in steps:
            pair.submit(name, p, t)
    pair.both("drain")
    pair.both("checkpoint")
    before, _ = pair.both("compute_all")
    pair.both("kill_shard", pair.t.shard_for("t0"))
    got, _ = pair.check()  # the fleet read recovers the dead shard inline
    assert digests(got) == digests(before) and pair.t.stats["failovers"] == 1
    pair.shutdown()


def test_auto_failover_off_raises_until_probe(tmp_path):
    pair = FabPair(tmp_path, num_shards=2, auto_failover=False)
    p, t = batches(1)["t0"][0]
    pair.submit("t0", p, t)
    pair.both("drain")
    pair.both("checkpoint")
    victim = pair.t.shard_for("t0")
    pair.both("kill_shard", victim)
    for fab, conv, error in ((pair.t, to_torch, ShardDeadError), (pair.j, to_jax, jfabric.ShardDeadError)):
        with pytest.raises(error):
            fab.submit("t0", conv(p), conv(t))
        with pytest.raises(error):
            fab.compute_all()
    assert pair.both("probe") == ([victim], [victim])
    pair.submit("t0", p, t)
    pair.both("drain")
    pair.check()
    pair.shutdown()


def test_failover_without_durable_state_is_refused():
    fab = ShardedMetricsService(TEMPLATES["acc8"][0](), num_shards=2, auto_failover=False)
    p, t = batches(1)["t0"][0]
    fab.submit("t0", to_torch(p), to_torch(t))
    fab.drain()
    fab.kill_shard(fab.shard_for("t0"))
    with pytest.raises(ShardDeadError, match="no durable state"):
        fab.fail_over(fab.shard_for("t0"))
    fab.shutdown()


def test_shard_death_fault_class_triggers_failover(tmp_path):
    data = batches(6)
    pair = FabPair(tmp_path, num_shards=2)
    for name, steps in data.items():
        for p, t in steps:
            pair.submit(name, p, t)
    pair.both("drain")
    pair.both("checkpoint")
    want, _ = pair.both("compute_all")
    victim = pair.t.shard_for("t0")
    with faults.inject("shard-death", count=1, shard=victim) as spec:
        got = pair.t.compute("t0")
    with metrics_tpu.faults.inject("shard-death", count=1, shard=victim):
        jgot = pair.j.compute("t0")
    assert spec.fired == 1
    close(got, jgot)
    assert as_numpy(got).tobytes() == as_numpy(want["t0"]).tobytes()
    assert pair.t.stats["failovers"] == pair.j.stats["failovers"] == 1
    assert pair.t.failover_events[0]["cause"] == "killed"
    other = 1 - victim
    assert pair.t._shards[other].epoch == pair.t._shards[other].service.epoch
    pair.check()
    pair.shutdown()


def test_the_fabric_fault_classes_are_registered():
    for name in ("shard-death", "shard-slow", "network-partition", "history-corruption"):
        assert name in faults.FAULT_NAMES and name in metrics_tpu.faults.FAULT_NAMES
    assert set(faults.FAULT_NAMES) == set(metrics_tpu.faults.FAULT_NAMES) - {"cache-corruption"}
    assert faults.CRASH_POINTS == metrics_tpu.faults.CRASH_POINTS


def test_heartbeat_marks_a_dead_shard_and_probe_fails_it_over(tmp_path):
    pair = FabPair(tmp_path, num_shards=3)
    _, ops = stream(n_sessions=9)
    pair.feed(ops)
    assert pair.both("heartbeat") == ({0: True, 1: True, 2: True},) * 2
    with faults.inject("shard-death", count=1, shard=2), metrics_tpu.faults.inject("shard-death", count=1, shard=2):
        beats = pair.both("heartbeat")
    assert beats[0] == beats[1] == {0: True, 1: True, 2: False}
    assert pair.both("probe") == ([2], [2])
    pair.check()
    assert digests(pair.t.compute_all()) == control(ops)
    pair.shutdown()


# --------------------------------------------------------- fleet aggregates
def test_queue_bounds_are_per_shard():
    fab = ShardedMetricsService(TEMPLATES["acc8"][0](), num_shards=2, max_queue=2, admission="reject")
    names = [f"t{i}" for i in range(8)]
    hot = [n for n in names if fab.shard_for(n) == 0][0]
    p, t = (to_torch(a) for a in batches(1)["t0"][0])
    rejected = 0
    for _ in range(6):
        try:
            fab.submit(hot, p, t)
        except QueueFullError:
            rejected += 1
    assert rejected == 4
    cold = next(n for n in names if fab.shard_for(n) != fab.shard_for(hot))
    fab.submit(cold, p, t)
    fab.drain()
    fab.shutdown()


def test_fleet_snapshot_aggregates_shards():
    data = batches(6)
    pair = FabPair(num_shards=3)
    for name, steps in data.items():
        for p, t in steps:
            pair.submit(name, p, t)
    pair.both("drain")
    snap, jsnap = pair.both("fleet_snapshot")
    assert snap["num_shards"] == jsnap["num_shards"] == 3
    assert snap["serve_totals"]["submits"] == jsnap["serve_totals"]["submits"] == 12
    assert snap["resilience"] == jsnap["resilience"] and snap["resilience"]["shards"] == 3
    assert snap["health"]["sessions"] == jsnap["health"]["sessions"] == len(data)
    assert {s["shard"] for s in snap["shards"].values()} == {0, 1, 2}
    assert snap["reads"] == jsnap["reads"]
    assert snap["cost"]["billed_requests"] == jsnap["cost"]["billed_requests"]
    assert set(snap) == set(jsnap)
    health, jhealth = pair.both("health")
    for h in (health, jhealth):
        for shard in h["shards"].values():
            del shard["breakers"], shard["capacity"]
    assert set(health) == set(jhealth) and health["failover_causes"] == jhealth["failover_causes"]
    pair.shutdown()


def test_forward_rides_the_stacked_launch_through_the_fabric():
    pair = FabPair(num_shards=2)
    rng = np.random.RandomState(3)
    p, t = rng.randint(0, C, 16), rng.randint(0, C, 16)
    out = {}
    ts, js = instrumented(lambda: out.update(zip(("t", "j"), pair.both("forward", "t0", p, t))))
    close(out["t"], out["j"])
    fresh = TEMPLATES["acc8"][0]()
    fresh.update(to_torch(p), to_torch(t))
    assert torch.equal(out["t"], fresh.compute())
    launches = ts.spans(name="update", kind="stacked-aot")
    assert len(launches) == 1 and "@shard" in launches[0].owner
    assert span_counts(ts) == span_counts(js)
    pair.shutdown()


def test_update_compute_and_session_lifecycle_route_to_the_owner(tmp_path):
    pair = FabPair(tmp_path, num_shards=3)
    data = batches(6)
    for name, steps in data.items():
        pair.both("update", name, *steps[0])
    got, want = pair.both("compute", "t1")
    close(got, want)
    pair.both("reset_session", "t2")
    pair.both("close_session", "t3")
    assert pair.t.session_count() == pair.j.session_count() == 5
    assert pair.both("open_session", "t3")[0] == pair.t._shards[pair.t.shard_for("t3")].service._rows["t3"]
    pair.check()
    pair.both("checkpoint")
    fresh = FabPair(tmp_path, num_shards=3)
    assert fresh.both("recover") == (3, 3)
    fresh.check()
    assert fresh.shard_digests()[0][0][1] == pair.shard_digests()[0][0][1]
    pair.shutdown()
    fresh.shutdown()
