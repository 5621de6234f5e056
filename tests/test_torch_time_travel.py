"""The port's checkpoint ladder and time travel against the JAX package's.

The behaviours of the serving half of ``tests/bases/test_time_travel.py``,
each held on the port and, where a value crosses, against the JAX package
fed the same numpy stream: the ladder keeps its rungs and pins the journal's
floor (no truncation orphans a rung's replay tail); ``service_at(t)``
resolves ``t`` to a sequence fence and equals a dedicated-metric oracle fed
exactly that prefix, and the JAX service's scratch at the same fence, to the
digest; ``compute_range``; ``clock-skew`` cannot reorder a replay;
``history-corruption`` is quarantined by ``scrub`` (renamed, never deleted)
while reads fall back to an older rung; ``recover`` falls back to the newest
verified rung; the offline scrubbers of both packages agree, exit 0 clean and
1 quarantined; rungs, checkpoints and journals written by either package
serve the other's ``compute_at``. Wall clocks are read only through the
journal's own ``ts`` headers: no test waits on or compares a duration.
"""
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu_torch
from metrics_tpu import serve as jserve
from metrics_tpu_torch import faults, telemetry, wal
from metrics_tpu_torch.fabric import ShardedMetricsService
from metrics_tpu_torch.serve import HistoryPolicy, MetricsService
from tests.test_torch_fabric import as_numpy, close

_C, _B = 8, 8


def _acc():
    return metrics_tpu_torch.Accuracy(task="multiclass", num_classes=_C, device="cpu")


def _jacc():
    return metrics_tpu.Accuracy(task="multiclass", num_classes=_C)


def _svc(root, history=None, jax=False, **kwargs):
    policy = (jserve.HistoryPolicy if jax else HistoryPolicy)(
        **(history or {"keep_last": 2}))
    cls = jserve.MetricsService if jax else MetricsService
    return cls(_jacc() if jax else _acc(), journal_dir=str(root / "wal"), checkpoint_dir=str(root / "ckpt"),
               history=policy, **kwargs)


def _batch(i):
    rng = np.random.RandomState(7000 + i)
    return rng.randint(0, _C, _B), rng.randint(0, _C, _B)


def _oracle(ops):
    refs = {}
    for name, preds, target in ops:
        refs.setdefault(name, _acc()).update(torch.from_numpy(preds), torch.from_numpy(target))
    return {k: v.compute().numpy() for k, v in refs.items()}


def _run_stream(svc, n_ops, sessions=3, flush_every=4, start=0):
    """An update-only stream; op i journals as seq i + 1 on a fresh service."""
    conv = torch.from_numpy if isinstance(svc, MetricsService) else jnp.asarray
    ops = []
    for i in range(start, start + n_ops):
        name = f"s{i % sessions}"
        preds, target = _batch(i)
        svc.submit(name, conv(preds), conv(target))
        ops.append((name, preds, target))
        if (i + 1) % flush_every == 0:
            svc.flush()
    svc.drain()
    return ops


def _assert_oracle(got, ops):
    want = _oracle(ops)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(as_numpy(got[name]), want[name])


# -------------------------------------------------------------------- ladder
def test_history_policy_validates_and_reprs_like_the_jax_one():
    assert repr(HistoryPolicy(2, 60)) == repr(jserve.HistoryPolicy(2, 60))
    with pytest.raises(ValueError):
        HistoryPolicy(keep_last=0)
    with pytest.raises(ValueError):
        HistoryPolicy(keep_last=1, keep_per_interval_s=0)
    with pytest.raises(TypeError):
        MetricsService(_acc(), history=object())


def test_ladder_retains_rungs_pins_the_floor_and_names_rungs_as_the_jax_package(tmp_path):
    svc, jsvc = _svc(tmp_path / "t"), _svc(tmp_path / "j", jax=True)
    try:
        for k in range(4):
            _run_stream(svc, 6, start=6 * k)
            _run_stream(jsvc, 6, start=6 * k)
            svc.checkpoint()
            jsvc.checkpoint()
        rungs, jrungs = svc._ladder_rungs(), jsvc._ladder_rungs()
        assert [f for f, _ in rungs] == [f for f, _ in jrungs] and len(rungs) == 2
        assert [os.path.basename(p) for _, p in rungs] == [os.path.basename(p) for _, p in jrungs]
        assert svc.journal.first_seq() <= rungs[0][0] + 1 and svc.journal.history_floor == rungs[0][0]
        assert svc.stats["history_rungs_gcd"] == jsvc.stats["history_rungs_gcd"] == 2
        with np.load(rungs[-1][1]) as a, np.load(jrungs[-1][1]) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                if key != "__meta__" and not key.startswith("__checksum__"):
                    np.testing.assert_array_equal(a[key], b[key])
    finally:
        svc.shutdown()
        jsvc.shutdown()


def test_manual_truncation_clamped_by_history_floor(tmp_path):
    svc = _svc(tmp_path)
    try:
        _run_stream(svc, 8)
        svc.checkpoint()
        _run_stream(svc, 8, start=8)
        svc.checkpoint()
        oldest = svc._ladder_rungs()[0][0]
        svc.journal.truncate(svc.journal.last_seq)
        assert svc.journal.first_seq() <= oldest + 1
    finally:
        svc.shutdown()


@pytest.mark.parametrize("seed", [0, 1])
def test_ladder_gc_interleaving_property(tmp_path, seed):
    rng = np.random.RandomState(seed)
    svc = _svc(tmp_path, history={"keep_last": 2, "keep_per_interval_s": 3600.0})
    ops = []
    try:
        for step in range(60):
            roll = rng.rand()
            if roll < 0.70 or not ops:
                name = f"s{rng.randint(3)}"
                preds, target = _batch(1000 * seed + step)
                svc.submit(name, torch.from_numpy(preds), torch.from_numpy(target))
                ops.append((name, preds, target))
                if rng.rand() < 0.3:
                    svc.flush()
            elif roll < 0.90:
                svc.checkpoint()
            else:
                svc.journal.truncate(svc.journal.last_seq)
            for fence, _ in svc._ladder_rungs():
                assert svc.journal.first_seq() <= fence + 1, f"step {step}: rung {fence} lost its replay tail"
        svc.drain()
        rungs = svc._ladder_rungs()
        assert rungs
        oldest_fence, oldest_path = rungs[0]
        scratch, fence = svc.service_at(float(svc._rung_meta(oldest_path)["ts"]))
        try:
            assert fence >= oldest_fence
            _assert_oracle(scratch.compute_all(), ops[:fence])
        finally:
            scratch.shutdown()
    finally:
        svc.shutdown()


# ---------------------------------------------------------------- compute_at
def test_compute_at_matches_the_prefix_oracle_and_the_jax_scratch(tmp_path):
    svc, jsvc = _svc(tmp_path / "t"), _svc(tmp_path / "j", jax=True)
    try:
        ops = _run_stream(svc, 12)
        _run_stream(jsvc, 12)
        svc.checkpoint()
        jsvc.checkpoint()
        ops += _run_stream(svc, 8, start=12)
        _run_stream(jsvc, 8, start=12)
        records, jrecords = svc.journal.read_tail(0), jsvc.journal.read_tail(0)
        assert [r.seq for r in records] == [r.seq for r in jrecords]
        base = svc.journal.first_seq() - 1
        assert base >= 1 and base == jsvc.journal.first_seq() - 1
        for k in (0, 2, len(records) // 2, len(records) - 1):
            t = records[k].ts
            want_fence = max([base] + [r.seq for r in records if r.ts is not None and r.ts <= t])
            scratch, fence = svc.service_at(t)
            jscratch, jfence = jsvc.service_at(jrecords[k].ts)
            try:
                assert fence == want_fence == jfence
                assert scratch.state_digest() == jscratch.state_digest()
                _assert_oracle(scratch.compute_all(), ops[:fence])
            finally:
                scratch.shutdown()
                jscratch.shutdown()
            got, want = svc.compute_at(t, "s1"), jsvc.compute_at(jrecords[k].ts, "s1")
            close(got, want)
    finally:
        svc.shutdown()
        jsvc.shutdown()


def test_compute_at_before_history_and_digest_identity(tmp_path):
    svc = _svc(tmp_path)
    twin = MetricsService(_acc())
    try:
        ops = _run_stream(svc, 10)
        assert svc.compute_at(0.0) == {}
        scratch, fence = svc.service_at(svc.journal.read_tail(0)[-1].ts)
        try:
            assert fence == 10
            for name, preds, target in ops[:fence]:
                twin.submit(name, torch.from_numpy(preds), torch.from_numpy(target))
            twin.drain()
            assert scratch.state_digest() == twin.state_digest()
        finally:
            scratch.shutdown()
    finally:
        twin.shutdown()
        svc.shutdown()


def test_compute_at_emits_time_travel_span_and_counter(tmp_path):
    telemetry.reset_counters()
    svc = _svc(tmp_path)
    try:
        _run_stream(svc, 6)
        with telemetry.instrument() as tr:
            svc.compute_at(svc.journal.read_tail(0)[-1].ts)
        spans = tr.spans(name="read", kind="time-travel")
        assert len(spans) == 1 and spans[0].attrs["fence"] == 6
        assert svc.stats["time_travel_reads"] == 1
        assert telemetry.snapshot()["read:time-travel"] == 1
    finally:
        svc.shutdown()


def test_compute_range_replays_the_ts_window(tmp_path):
    svc, jsvc = _svc(tmp_path / "t"), _svc(tmp_path / "j", jax=True)
    try:
        ops = _run_stream(svc, 12)
        _run_stream(jsvc, 12)
        records, jrecords = svc.journal.read_tail(0), jsvc.journal.read_tail(0)
        picked = [r.seq for r in records if records[3].ts < r.ts <= records[8].ts]
        got = svc.compute_range(records[3].ts, records[8].ts)
        _assert_oracle(got, [ops[s - 1] for s in picked])
        if picked == [r.seq for r in jrecords if jrecords[3].ts < r.ts <= jrecords[8].ts]:
            want = jsvc.compute_range(jrecords[3].ts, jrecords[8].ts)
            for name in want:
                close(got[name], want[name])
        close(svc.compute_range(records[3].ts, records[8].ts, "s0"), got["s0"])
        with pytest.raises(ValueError):
            svc.compute_range(records[8].ts, records[3].ts)
    finally:
        svc.shutdown()
        jsvc.shutdown()


def test_clock_skew_fault_cannot_reorder_time_travel(tmp_path):
    svc = _svc(tmp_path)
    try:
        ops = _run_stream(svc, 4, flush_every=2)
        with faults.inject("clock-skew", count=1, skew_s=3600.0):
            preds, target = _batch(99)
            svc.submit("s0", torch.from_numpy(preds), torch.from_numpy(target))
            ops.append(("s0", preds, target))
            svc.flush()
        ops += _run_stream(svc, 3, flush_every=2, start=4)
        records = svc.journal.read_tail(0)
        assert records[4].ts < records[3].ts - 3000
        scratch, fence = svc.service_at(records[3].ts)
        try:
            assert fence == 5
            _assert_oracle(scratch.compute_all(), ops[:5])
        finally:
            scratch.shutdown()
    finally:
        svc.shutdown()


# --------------------------------------------------------------------- scrub
def test_history_corruption_scrub_quarantines_and_reads_fall_back(tmp_path):
    svc = _svc(tmp_path, history={"keep_last": 3})
    try:
        ops = _run_stream(svc, 6)
        svc.checkpoint()
        ops += _run_stream(svc, 6, start=6)
        with faults.inject("history-corruption", count=1) as spec:
            svc.checkpoint()
        assert spec.fired == 1
        rungs = svc._ladder_rungs()
        assert len(rungs) == 2
        bad_fence, bad_path = rungs[-1]
        with telemetry.instrument() as tr:
            got = svc.compute_at(svc.journal.read_tail(0)[-1].ts)
        assert tr.spans(name="degrade", kind="history")
        _assert_oracle(got, ops)
        assert os.path.exists(bad_path)  # a read never changes the ladder
        report = svc.scrub()
        assert report["quarantined"] == [bad_path] and report["newest_verified"] == bad_fence
        assert not os.path.exists(bad_path) and os.path.exists(bad_path + ".quarantine")
        assert svc.stats["quarantined_rungs"] == 1
        report2 = svc.scrub()
        assert report2["quarantined"] == [] and rungs[0][0] in report2["verified"]
        assert svc.scrub(quarantine=False)["checked"] == report2["checked"]
    finally:
        svc.shutdown()


def test_recover_falls_back_to_the_newest_verified_rung(tmp_path):
    svc = _svc(tmp_path)
    ops = _run_stream(svc, 8)
    svc.checkpoint()
    ops += _run_stream(svc, 5, start=8)
    svc.shutdown()
    ckpt = str(tmp_path / "ckpt")
    (head,) = [os.path.join(ckpt, n) for n in os.listdir(ckpt) if ".rung-" not in n and n.endswith(".npz")]
    with open(head, "rb") as f:
        blob = f.read()
    os.remove(head)  # the rung is a hard link of the head: rot the head's own copy
    with open(head, "wb") as f:
        f.write(blob)
    MetricsService._corrupt_rung_file(head)
    svc2 = _svc(tmp_path)
    try:
        with telemetry.instrument() as tr:
            assert svc2.recover()
        assert tr.spans(name="degrade", kind="history")
        assert svc2.stats["quarantined_rungs"] == 1 and os.path.exists(head + ".quarantine")
        _assert_oracle(svc2.compute_all(), ops)
    finally:
        svc2.shutdown()


def test_offline_scrubbers_of_both_packages_agree(tmp_path):
    from tools import torch_wal_scrub, wal_scrub

    svc = _svc(tmp_path)
    _run_stream(svc, 6)
    svc.checkpoint()
    _run_stream(svc, 6, start=6)
    svc.checkpoint()
    rungs = svc._ladder_rungs()
    svc.shutdown()
    ckpt, journal = str(tmp_path / "ckpt"), str(tmp_path / "wal")
    args = ["--checkpoint-dir", ckpt, "--journal-dir", journal]

    def reports():
        return (torch_wal_scrub.scrub(ckpt, journal, quarantine=False),
                wal_scrub.scrub(ckpt, journal, quarantine=False))

    ours, theirs = reports()
    assert ours == theirs and ours["quarantined"] == []
    assert torch_wal_scrub.main(args) == 0
    MetricsService._corrupt_rung_file(rungs[0][1])
    ours, theirs = reports()
    assert ours["quarantined"] == theirs["quarantined"] == [rungs[0][1]]
    assert [r["ok"] for r in ours["rungs"]] == [r["ok"] for r in theirs["rungs"]]
    assert torch_wal_scrub.main(args + ["--dry-run"]) == 1 and os.path.exists(rungs[0][1])
    assert torch_wal_scrub.main(args + ["--json"]) == 1 and os.path.exists(rungs[0][1] + ".quarantine")
    assert torch_wal_scrub.main(args) == 0 == wal_scrub.main(args)
    assert torch_wal_scrub.main(["--checkpoint-dir", str(tmp_path / "nope")]) == 2


def test_scrub_worker_runs_in_the_background_and_reports(tmp_path):
    svc = _svc(tmp_path, scrub_interval_s=0.01)
    try:
        _run_stream(svc, 6)
        svc.checkpoint()
        # a pass holds the flush lock, as the checkpoint does, but counts itself after it lets go: the second
        # pass counted from here started after the checkpoint
        base = svc.telemetry_snapshot()["history"]["runs"]
        deadline = time.monotonic() + 60.0
        while svc.telemetry_snapshot()["history"]["runs"] < base + 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        history = svc.telemetry_snapshot()["history"]
        assert history["runs"] >= base + 2 and history["errors"] == 0
        assert history["last"]["quarantined"] == [] and history["last"]["checked"] == 2
        assert "scrub-worker" in telemetry.thread_names().values()
    finally:
        svc.shutdown()
    assert svc._scrub_thread is None


# ------------------------------------------------------------- across packages
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_rungs_and_journals_of_either_package_serve_the_others_compute_at(tmp_path, writer):
    src = _svc(tmp_path, jax=writer == "jax")
    ops = _run_stream(src, 10)
    src.checkpoint()
    ops += _run_stream(src, 7, start=10)
    src.checkpoint()
    ops += _run_stream(src, 5, start=17)
    records = src.journal.read_tail(0)
    instants = [records[0].ts, records[len(records) // 2].ts, records[-1].ts]
    want = [src.compute_at(t) for t in instants]
    src.shutdown()
    dst = _svc(tmp_path, jax=writer == "torch")  # the same directories, opened by the other package
    try:
        for t, expected in zip(instants, want):
            got = dst.compute_at(t)
            assert sorted(got) == sorted(expected)
            for name in expected:
                close(got[name], expected[name])
        assert dst.scrub()["quarantined"] == []
    finally:
        dst.shutdown()


def test_capacity_shards_and_the_fabric_fan_time_travel_out(tmp_path):
    cap = MetricsService(_acc(), shard_capacity=2, journal_dir=str(tmp_path / "cw"),
                         checkpoint_dir=str(tmp_path / "cc"), history=HistoryPolicy(keep_last=2))
    fab = ShardedMetricsService(_acc(), num_shards=2, data_dir=str(tmp_path / "fab"))
    ops = []
    for i in range(12):
        preds, target = _batch(i)
        for svc in (cap, fab):
            svc.submit(f"s{i % 4}", torch.from_numpy(preds), torch.from_numpy(target))
        ops.append((f"s{i % 4}", preds, target))
    for svc in (cap, fab):
        svc.drain()
    cap.checkpoint()  # the capacity shards keep ladders; the fabric's shards replay their whole journals
    t = time.time()
    _assert_oracle(cap.compute_at(t), ops)
    _assert_oracle(fab.compute_at(t), ops)
    close(fab.compute_at(t, "s2"), _oracle(ops)["s2"])
    # a range reads the retained journal: the capacity shards' checkpoint truncated it up to their rungs' fence
    assert cap.compute_range(0.0, t) == {}
    assert sorted(fab.compute_range(0.0, t)) == ["s0", "s1", "s2", "s3"]
    assert cap.scrub()["quarantined"] == [] and cap.scrub()["checked"] == 4
    assert set(fab.scrub()) == {0, 1}
    cap.shutdown()
    fab.shutdown()


def test_wal_records_carry_wall_clock_ts(tmp_path):
    log = wal.WriteAheadLog(str(tmp_path / "wal"), owner="test")
    t0 = time.time()
    log.append(wal.UPDATE, "s0", (np.zeros(2, np.float32),))
    rec = log.read_tail(0)[0]
    assert rec.ts is not None and t0 - 1.0 <= rec.ts <= time.time() + 1.0
