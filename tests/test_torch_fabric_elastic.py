"""The port's elastic fabric against the JAX package's: hand-off, replication, gray failures.

The behaviours of ``tests/bases/test_fabric_elastic.py``, held with the same
numpy streams through both packages' fabrics (``tests/test_torch_fabric.py``'s
``FabPair``): after any sequence of ``add_shard`` / ``remove_shard`` /
``rebalance`` / standby promotion every shard's digest equals the JAX
fabric's and every value an unsharded service's; a hand-off moves about 1/N
sessions; a promoted standby replays only the unshipped tail; anti-entropy
repairs a divergent standby; exactly one side of a partition wins.

The suspicion sweep compares the shards' served p99s. Here both packages'
services read one fake clock that a ``shard-slow`` sleep advances by its
40 ms and every other reading by 1 µs, so the slow shard's p99 stands
thousands of times above its peers' on any host, however loaded.
"""
import math
import types

import numpy as np
import pytest

import metrics_tpu
from metrics_tpu import fabric as jfabric
from metrics_tpu_torch import faults, serve
from metrics_tpu_torch.fabric import FleetDeadError, ShardedMetricsService, StaleEpochError
from tests.test_torch_fabric import TEMPLATES, FabPair, control, digests, instrumented, span_counts, stream, to_jax, \
    to_torch


def _feed(pair, ops):
    pair.feed(ops)


# --------------------------------------------------------------- fleet death
def test_fleet_dead_error_names_dead_shards(tmp_path):
    pair = FabPair(tmp_path, num_shards=2)
    _, ops = stream(n_sessions=4, ops=1)
    _feed(pair, ops)
    pair.both("checkpoint")
    for k in range(2):
        pair.both("kill_shard", k)
    for fab, error in ((pair.t, FleetDeadError), (pair.j, jfabric.FleetDeadError)):
        with pytest.raises(error, match=r"dead shards: \[0, 1\]"):
            fab.fail_over(0)
    pair.shutdown()


def test_remove_last_shard_raises_fleet_dead(tmp_path):
    fab = ShardedMetricsService(TEMPLATES["acc8"][0](), num_shards=1, data_dir=str(tmp_path))
    with pytest.raises(FleetDeadError, match="last live shard"):
        fab.remove_shard(0)
    fab.shutdown()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rebalance_minimality_and_digest_parity(tmp_path, seed):
    names, ops = stream(n_sessions=24, seed=seed)
    pair = FabPair(tmp_path, num_shards=3)
    _feed(pair, ops)
    sid, jsid = pair.both("add_shard")
    assert sid == jsid == 3
    report, jreport = pair.both("rebalance")
    moved = report["moved"]
    assert moved == jreport["moved"] and report["handoffs"] == jreport["handoffs"]
    assert moved and len(moved) <= math.ceil(len(names) / 4) + 2
    assert all(pair.t.shard_for(n) == sid for n in moved)
    got, _ = pair.check()
    assert digests(got) == control(ops)
    planned = [e for e in pair.t.failover_events if e["cause"] == "planned"]
    assert planned and all(e["peer"] == sid for e in planned)
    pair.shutdown()


def test_handoff_under_live_traffic_exactly_once(tmp_path):
    _, ops = stream(n_sessions=18, ops=4)
    third = len(ops) // 3
    pair = FabPair(tmp_path, num_shards=2)
    pair.feed(ops[:third], drain=False)
    pair.both("add_shard")
    pair.both("rebalance")
    pair.feed(ops[third:2 * third], drain=False)
    moved, jmoved = pair.both("remove_shard", 0)
    assert moved == jmoved
    pair.feed(ops[2 * third:])
    got, _ = pair.check()
    assert digests(got) == control(ops)
    health, jhealth = pair.both("health")
    assert health["shards"][0]["retired"] is True and health["handoffs"] == jhealth["handoffs"] >= 2
    pair.shutdown()


def test_remove_shard_archives_slo_counts(tmp_path):
    _, ops = stream(n_sessions=12)
    pair = FabPair(tmp_path, num_shards=3)
    _feed(pair, ops)
    served_before = sum(int(s["totals"]["served"]) for s in pair.t.slo_snapshot().values())
    pair.both("remove_shard", 1)
    snap, jsnap = pair.both("slo_snapshot")
    assert 1 in snap and set(snap) == set(jsnap)
    assert sum(int(s["totals"]["served"]) for s in snap.values()) == served_before == len(ops)
    pair.check()
    pair.shutdown()


def test_rebalance_fences_every_arc_loser(tmp_path):
    fab = ShardedMetricsService(TEMPLATES["acc8"][0](), num_shards=3, data_dir=str(tmp_path))
    fab.add_shard()
    losers = fab.ring.arc_losers(fab._target_ring)
    assert losers
    fenced = []
    real_fence = fab._fence
    fab._fence = lambda ids: (fenced.extend(ids), real_fence(ids))[1]
    fab.rebalance()
    assert set(fenced) == set(losers)
    fab.shutdown()


def test_submit_racing_the_fence_is_not_stranded(tmp_path):
    _, ops = stream(n_sessions=8)
    fab = ShardedMetricsService(TEMPLATES["acc8"][0](), num_shards=2, data_dir=str(tmp_path))
    for name, p, t in ops:
        fab.submit(name, to_torch(p), to_torch(t))
    fab.drain()
    fab.add_shard()
    target = fab._target_ring
    losers = fab.ring.arc_losers(target)
    victim = next(f"race{i}" for i in range(10_000)
                  if fab.ring.owner(f"race{i}") in losers and fab.ring.owner(f"race{i}") != target.owner(f"race{i}"))
    src = fab._shards[fab.ring.owner(victim)]
    x = to_torch(np.arange(16) % 8)
    real_drain = src.service.drain
    fired = []

    def racing_drain():
        real_drain()
        if not fired:  # after the fence, before the plan (once: the checkpoint drains again)
            fired.append(True)
            src.service.submit(victim, x, x)
            src.service.flush()
            real_drain()

    src.service.drain = racing_drain
    try:
        report = fab.rebalance()
    finally:
        src.service.drain = real_drain
    assert victim in report["moved"]
    holders = [s.shard_id for s in fab._shards if not s.retired and victim in s.service._rows]
    assert holders == [fab.shard_for(victim)] == [target.owner(victim)]
    assert float(fab.compute(victim)) == 1.0
    fab.shutdown()


def test_add_shard_rebases_rid_lattice_immediately(tmp_path):
    pair = FabPair(tmp_path, num_shards=2)
    pair.both("add_shard")
    for fab in (pair.t, pair.j):
        live = [s for s in fab._shards if not s.retired]
        assert {s.service._rid_stride for s in live} == {len(live)}
        assert len({s.service._rid % s.service._rid_stride for s in live}) == len(live)
    assert [s.service._rid for s in pair.t._shards] == [s.service._rid for s in pair.j._shards]
    pair.shutdown()


def test_rid_lattice_stays_disjoint_after_membership_changes(tmp_path):
    pair = FabPair(tmp_path, num_shards=3)
    _, ops = stream(n_sessions=12)
    _feed(pair, ops)
    pair.both("add_shard")
    pair.both("rebalance")
    pair.both("remove_shard", 0)
    live = [s for s in pair.t._shards if not s.retired]
    assert {s.rid_stride for s in live} == {len(live)}
    assert len({s.rid_offset % s.rid_stride for s in live}) == len(live)
    assert ([(s.rid_offset, s.rid_stride) for s in pair.t._shards]
            == [(s.rid_offset, s.rid_stride) for s in pair.j._shards])
    pair.check()
    pair.shutdown()


# ------------------------------------------------------ standby replication
def test_standby_failover_replays_only_unshipped_tail(tmp_path):
    _, ops = stream(n_sessions=18, ops=4)
    half = len(ops) // 2
    pair = FabPair(tmp_path, num_shards=3, standby=True)
    _feed(pair, ops[:half])
    pair.both("replicate")  # seed
    assert pair.both("replicate")[0] == pair.j.replicate()  # ship everything so far (then nothing)
    _feed(pair, ops[half:])
    total = pair.t._shards[0].service.journal.last_seq
    shipped = pair.t._standbys[0].applied_seq
    assert 0 < shipped < total and shipped == pair.j._standbys[0].applied_seq
    pair.both("kill_shard", 0)
    pair.both("fail_over", 0)
    event = pair.t.failover_events[-1]
    assert event["standby"] is True and event["cause"] == "killed"
    assert 0 < event["replayed"] <= total - shipped
    got, _ = pair.check()
    assert digests(got) == control(ops)
    pair.shutdown()


def test_checkpoint_truncation_cannot_silently_drop_replicated_records(tmp_path):
    _, ops = stream(n_sessions=12, ops=4)
    q = len(ops) // 4
    pair = FabPair(tmp_path, num_shards=2, standby=True)
    _feed(pair, ops[:q])
    pair.both("replicate")
    pair.both("replicate")
    for fab in (pair.t, pair.j):
        fab.victim_cursor = fab._standbys[0].cursor
    _feed(pair, ops[q:2 * q])
    for fab in (pair.t, pair.j):
        svc = fab._shards[0].service
        svc.checkpoint()
        assert svc.journal.first_seq() <= fab.victim_cursor + 1
        fab.replicate()
        assert fab._standbys[0].stats["reseeds"] == 1
    _feed(pair, ops[2 * q:3 * q])
    for fab in (pair.t, pair.j):
        svc = fab._shards[0].service
        svc.journal.retain_seq = None
        svc.checkpoint()
        assert svc.journal.first_seq() > fab._standbys[0].cursor + 1  # a real gap
        fab.replicate()
        assert fab._standbys[0].stats["reseeds"] == 2
        assert fab.anti_entropy() == []
    _feed(pair, ops[3 * q:])
    pair.both("kill_shard", 0)
    pair.both("fail_over", 0)
    assert pair.t.failover_events[-1]["standby"] is True
    got, _ = pair.check()
    assert digests(got) == control(ops)
    pair.shutdown()


def test_anti_entropy_detects_and_repairs_divergence(tmp_path):
    _, ops = stream(n_sessions=12)
    pair = FabPair(tmp_path, num_shards=3, standby=True)
    _feed(pair, ops)
    pair.both("replicate")
    pair.both("replicate")
    assert pair.both("anti_entropy") == ([], [])
    victim = next(iter(pair.t._standbys))
    replica = pair.t._standbys[victim].service
    name = sorted(replica._rows)[0]
    replica.import_sessions({"rows": {name: {
        leaf: np.zeros_like(arr) for leaf, arr in replica.export_sessions([name])["rows"][name].items()
    }}})
    assert pair.t.anti_entropy() == [victim]
    assert pair.t.anti_entropy() == []
    assert pair.t._standbys[victim].stats["reseeds"] >= 2
    snap, jsnap = pair.both("fleet_snapshot")
    assert set(snap["replication"]) == set(jsnap["replication"])
    pair.shutdown()


def test_quantized_replication_ships_int8_frames_and_stays_within_budget(tmp_path):
    rng = np.random.RandomState(5)
    ops = [(f"m{i % 6}", (rng.rand(64) * 10).astype(np.float32)) for i in range(24)]
    pair = FabPair(tmp_path, num_shards=2, template="mean", standby=True, replication_precision="int8")
    pair.feed(ops)
    ts, js = instrumented(lambda: (pair.both("replicate"), pair.both("replicate")))
    ships = ts.spans(name="replicate", kind="ship")
    assert ships and all(e.attrs["quantized"] for e in ships)
    assert [e.attrs["nbytes"] for e in ships] == [e.attrs["nbytes"] for e in js.spans(name="replicate", kind="ship")]
    assert pair.both("anti_entropy") == ([], [])
    for sid, standby in pair.t._standbys.items():
        assert standby.lossy_budget == pytest.approx(pair.j._standbys[sid].lossy_budget, rel=1e-6)
    with pytest.raises(ValueError):
        ShardedMetricsService(TEMPLATES["mean"][0](), num_shards=2, replication_precision="int4")
    pair.shutdown()


def test_replicated_failover_replays_fewer_records_than_full_replay(tmp_path):
    """The point of shipping the log, counted rather than timed: a promoted
    standby replays the unshipped tail, a full failover the whole journal."""
    _, ops = stream(n_sessions=8, ops=8, batch=8)
    replayed = {}
    for mode in ("standby", "full"):
        fab = ShardedMetricsService(TEMPLATES["acc8"][0](), num_shards=2, data_dir=str(tmp_path / mode),
                                    standby=mode == "standby")
        for name, p, t in ops:
            fab.submit(name, to_torch(p), to_torch(t))
        fab.drain()
        if mode == "standby":
            fab.replicate()
            fab.replicate()
        for name, p, t in ops[:4]:
            fab.submit(name, to_torch(p), to_torch(t))
        fab.drain()
        fab.kill_shard(0)
        fab.fail_over(0)
        event = fab.failover_events[-1]
        assert event["standby"] is (mode == "standby")
        replayed[mode] = event.get("replayed", fab._shards[0].service.stats["replayed_records"])
        fab.shutdown()
    assert 0 < replayed["standby"] < replayed["full"], replayed


# ----------------------------------------------------------- gray failures
def test_split_brain_exactly_one_side_wins(tmp_path):
    names, ops = stream(n_sessions=18)
    half = len(ops) // 2
    pair = FabPair(tmp_path, num_shards=3, standby=True)
    _feed(pair, ops[:half])
    pair.both("replicate")
    pair.both("replicate")
    victim = 2
    zombie = pair.t._shards[victim].service
    with faults.inject("network-partition", count=1, shard=victim), \
            metrics_tpu.faults.inject("network-partition", count=1, shard=victim):
        pair.feed(ops[half:], drain=False)
    pair.both("drain")
    event = next(e for e in pair.t.failover_events if e["cause"] == "partition")
    assert event["shard"] == victim
    zname = next(n for n in names if pair.t.shard_for(n) == victim)
    with pytest.raises(StaleEpochError):
        zombie.submit(zname, *(to_torch(a) for a in ops[0][1:]))
        zombie.flush()
    with pytest.raises(StaleEpochError):
        zombie.journal.truncate(0)
    with pytest.raises(StaleEpochError):
        zombie.checkpoint()
    got, _ = pair.check()
    assert digests(got) == control(ops)
    pair.shutdown()


class _FakeClock:
    """A clock for both packages' services: every reading advances it by 1 µs,
    a sleep by its length, so a ``shard-slow`` flush costs exactly its ``ms``
    and nothing else costs more than a few µs."""

    def __init__(self, real):
        self.real, self.now = real, 1000.0

    def _tick(self):
        self.now += 1e-6
        return self.now

    def module(self):
        ns = types.SimpleNamespace(**{k: getattr(self.real, k) for k in dir(self.real) if not k.startswith("__")})
        ns.monotonic = ns.perf_counter = self._tick
        ns.sleep = self.sleep
        return ns

    def sleep(self, s):
        self.now += float(s)


@pytest.mark.parametrize("num_shards", [3, 2])
def test_suspicion_sweep_quarantines_the_slow_shard(tmp_path, monkeypatch, num_shards):
    clock = _FakeClock(serve.time)
    monkeypatch.setattr(serve, "time", clock.module())
    monkeypatch.setattr(metrics_tpu.serve, "time", clock.module())
    pair = FabPair(tmp_path, num_shards=num_shards, standby=True)
    rng = np.random.RandomState(0)
    names = [f"t{i}" for i in range(8 * num_shards)]
    for n in names:
        pair.both("open_session", n)
    x, y = rng.randint(0, 8, 16), rng.randint(0, 8, 16)

    def closed_loop(n_ops):
        for i in range(n_ops):
            name = names[i % len(names)]
            for fab, conv in ((pair.t, to_torch), (pair.j, to_jax)):
                svc = fab._route(name).service
                svc.submit(name, conv(x), conv(y))
                svc.flush()
                svc.drain()

    closed_loop(40 * num_shards)
    pair.both("replicate")
    slow = 0
    assert pair.both("suspicion_sweep", min_requests=32) == ([], [])
    with faults.inject("shard-slow", count=500, shard=slow, ms=40), \
            metrics_tpu.faults.inject("shard-slow", count=500, shard=slow, ms=40):
        closed_loop(100)
        suspects = pair.both("suspicion_sweep", min_requests=32)
    assert suspects == ([slow], [slow])
    event = pair.t.failover_events[-1]
    assert event["cause"] == "suspect-slow" and event["shard"] == slow
    assert pair.t.health()["failover_causes"]["suspect-slow"] == 1
    assert pair.t._shards[slow].alive and not pair.t._shards[slow].suspect
    pair.check()
    pair.both("update", next(n for n in names if pair.t.shard_for(n) == slow), x, y)
    pair.shutdown()


def test_failover_cause_field(tmp_path):
    _, ops = stream(n_sessions=12)
    pair = FabPair(tmp_path, num_shards=3)
    _feed(pair, ops)
    pair.both("kill_shard", 1)
    pair.both("fail_over", 1)
    assert pair.t.failover_events[-1]["cause"] == "killed"
    pair.both("add_shard")
    pair.both("rebalance")
    causes, jcauses = pair.both("failover_causes")
    assert causes == jcauses and causes["killed"] == 1 and causes["planned"] >= 1
    pair.check()
    pair.shutdown()


# ------------------------------------------------------------ pooled reads
def test_pooled_reads_match_sequential_and_the_fabric_spans(tmp_path):
    _, ops = stream(n_sessions=16)
    pair = FabPair(tmp_path, num_shards=4)
    _feed(pair, ops)
    out = {}
    ts, js = instrumented(lambda: out.update(zip(("t", "j"), pair.both("compute_all"))))
    assert span_counts(ts) == span_counts(js)
    sequential = {}
    for s in pair.t._serving_shards():
        sequential.update(s.service.compute_all())
    assert digests(out["t"]) == digests(sequential)
    assert pair.t._pool is not None
    assert set(pair.t.slo_snapshot()) == {0, 1, 2, 3}
    snap, jsnap = pair.both("fleet_snapshot")
    assert set(snap["shards"]) == {0, 1, 2, 3} and set(snap) == set(jsnap)
    assert set(snap["timeline"]) == {0, 1, 2, 3}
    pair.shutdown()


def test_membership_and_failover_spans_match_the_jax_fabric(tmp_path):
    _, ops = stream(n_sessions=12)
    pair = FabPair(tmp_path, num_shards=3, standby=True)
    _feed(pair, ops)

    def drill():
        pair.both("replicate")
        pair.both("replicate")
        pair.both("anti_entropy")
        pair.both("kill_shard", 0)
        pair.both("fail_over", 0)
        pair.both("add_shard")
        pair.both("rebalance")
        pair.both("remove_shard", 1)

    ts, js = instrumented(drill)
    fabric_spans = {"failover", "handoff", "membership", "replicate", "anti-entropy"}
    assert span_counts(ts, fabric_spans) == span_counts(js, fabric_spans)
    assert span_counts(ts, fabric_spans)[("membership", "add-shard")] == 1
    pair.check()
    pair.shutdown()


# --------------------------------------------------------------- the load harness
def _loadgen():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools", "torch_loadgen.py")
    spec = importlib.util.spec_from_file_location("torch_loadgen", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_loadgen_overload_keeps_its_structural_checks(tmp_path):
    """2x overload over three in-process shards: per-shard launches, the
    queue bound held on every shard, no collective on the submit path, and
    shedding; the trace is the JAX harness's for the same seed."""
    from tools import loadgen as jloadgen

    loadgen = _loadgen()
    trace, jtrace = loadgen.make_trace(0, 32, 500), jloadgen.make_trace(0, 32, 500)
    assert all(np.array_equal(trace[k], jtrace[k]) for k in trace)
    out = tmp_path / "report.json"
    assert loadgen.main(["--device", "cpu", "--events", "800", "--sessions", "32", "--shards", "3",
                         "--max-queue", "16", "--out", str(out)]) == 0
    import json

    report = json.loads(out.read_text())
    assert report["violations"] == [] and report["device"] == "cpu" and report["submit_collectives"] == 0
    assert report["max_queue_depth_sampled"] <= 16 and report["shed"] > 0
    assert set(report["launches_by_owner"]) == {f"MetricsService[Accuracy]@shard{k}" for k in range(3)}


def test_loadgen_elastic_drill_lands_every_admitted_request_once(tmp_path):
    loadgen = _loadgen()
    out = tmp_path / "report.json"
    assert loadgen.main(["--device", "cpu", "--events", "600", "--sessions", "32", "--shards", "3",
                         "--add-shard-at", "150", "--remove-shard-at", "300", "--partition", "1",
                         "--out", str(out)]) == 0
    import json

    report = json.loads(out.read_text())
    assert report["violations"] == [] and report["ledger_sessions"] == 32
    assert report["failover_causes"]["partition"] == 1 and report["failover_causes"]["planned"] >= 2


def test_loadgen_subprocess_shards_and_a_killed_shard_fail_over(tmp_path):
    loadgen = _loadgen()
    out = tmp_path / "report.json"
    assert loadgen.main(["--device", "cpu", "--subprocess", "--shards", "2", "--events", "600", "--sessions", "32",
                         "--kill-shard", "1", "--kill-delay-s", "0.5", "--data-dir", str(tmp_path / "fleet"),
                         "--out", str(out)]) == 0
    import json

    report = json.loads(out.read_text())
    # the kill lands wherever the worker is (before or after it claimed its epoch): the peer fences one above it
    assert report["killed_shard"] == 1 and report["recovered_epoch"] >= 1 and set(report["per_shard"]) == {"0"}
    assert report["failover_to_first_result_ms"] > 0
