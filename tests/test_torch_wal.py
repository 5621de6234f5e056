"""The port's write-ahead journal (metrics_tpu_torch/wal.py) against the JAX package's.

The behaviours of ``tests/bases/test_wal.py`` on the port (frames, the torn
tail, fencing, truncation and the retain floor, epochs, the kill switch),
journals written by one package read back in the other with the same
records, and the replication frames (ship and seed, q8) in both directions.
"""
import os

import numpy as np
import pytest

import torch

from metrics_tpu import wal as jwal
from metrics_tpu_torch import telemetry, wal
from metrics_tpu_torch.resilience import StateCorruptionError


def _log(tmp_path, **kwargs):
    kwargs.setdefault("segment_max_bytes", 4096)
    return wal.WriteAheadLog(str(tmp_path / "wal"), owner="test", **kwargs)


def _append_updates(log, n, start=0):
    for i in range(start, start + n):
        log.append(
            wal.UPDATE, f"s{i % 3}",
            (np.arange(4, dtype=np.float32) + i,),
            {"flag": True},
        )


# ------------------------------------------------------------- round trip
def test_append_read_roundtrip(tmp_path):
    log = _log(tmp_path)
    seq = log.append(wal.UPDATE, "tenant", (np.asarray([1.0, 2.0], np.float32),), {"k": 3})
    assert seq == 1 and log.last_seq == 1
    log.append(wal.CLOSE, "tenant")
    log.append(wal.RESET, "other")
    records = log.read_tail(0)
    assert [r.kind for r in records] == [wal.UPDATE, wal.CLOSE, wal.RESET]
    assert [r.seq for r in records] == [1, 2, 3]
    assert records[0].session == "tenant"
    np.testing.assert_array_equal(records[0].args[0], np.asarray([1.0, 2.0], np.float32))
    assert records[0].kwargs == {"k": 3}  # non-array statics keep their types
    assert isinstance(records[0].kwargs["k"], int)


def test_reopen_resumes_sequence(tmp_path):
    log = _log(tmp_path)
    _append_updates(log, 5)
    log.close()
    log2 = _log(tmp_path)
    assert log2.last_seq == 5
    assert log2.append(wal.UPDATE, "s0", (np.zeros(2, np.float32),)) == 6


def test_sequence_fencing_is_exact(tmp_path):
    log = _log(tmp_path)
    _append_updates(log, 8)
    assert [r.seq for r in log.read_tail(5)] == [6, 7, 8]
    assert log.read_tail(8) == []
    # idempotent: reading the same tail twice returns the same records
    assert [r.seq for r in log.read_tail(5)] == [6, 7, 8]


def test_drop_records_resolve_away_their_victims(tmp_path):
    log = _log(tmp_path)
    _append_updates(log, 4)  # seqs 1-4
    log.append(wal.DROP, "s1", drop_seq=2, drop_cause="queue-full-shed")
    records = log.read_tail(0)
    assert [r.seq for r in records] == [1, 3, 4]  # 2 shed, DROP itself resolved
    assert all(r.kind == wal.UPDATE for r in records)


# ------------------------------------------------------------- durability
def test_torn_tail_is_discarded_and_truncated(tmp_path):
    log = _log(tmp_path)
    _append_updates(log, 3)
    log.close()
    path = sorted(os.listdir(tmp_path / "wal"))[-1]
    full = os.path.join(str(tmp_path / "wal"), path)
    size = os.path.getsize(full)
    with open(full, "ab") as f:  # half a frame: a crash mid-append
        f.write(b"MTWL" + b"\x07" * 9)
    log2 = _log(tmp_path)
    assert log2.last_seq == 3
    assert log2.stats()["discarded_frames"] == 1
    assert os.path.getsize(full) == size  # physically truncated back
    assert len(log2.read_tail(0)) == 3


def test_complete_frame_corruption_refuses_to_open(tmp_path):
    log = _log(tmp_path)
    _append_updates(log, 3)
    log.close()
    seg = sorted(os.listdir(tmp_path / "wal"))[-1]
    full = os.path.join(str(tmp_path / "wal"), seg)
    with open(full, "r+b") as f:
        f.seek(40)  # inside frame 1's body: crc must catch it
        f.write(b"\xff\xff\xff")
    with pytest.raises(StateCorruptionError, match="crc32|magic"):
        _log(tmp_path)


def test_missing_middle_segment_refuses_to_open(tmp_path):
    log = _log(tmp_path, segment_max_bytes=4096)
    big = np.zeros(1200, np.float32)  # ~4.8KB payload: one frame per segment
    for i in range(4):
        log.append(wal.UPDATE, "s", (big + i,))
    log.close()
    segs = sorted(os.listdir(tmp_path / "wal"))
    assert len(segs) >= 3
    os.remove(os.path.join(str(tmp_path / "wal"), segs[1]))
    with pytest.raises(StateCorruptionError, match="missing or reordered"):
        _log(tmp_path)


# ------------------------------------------------------------- truncation
def test_truncate_preserves_sequence_floor(tmp_path):
    log = _log(tmp_path, segment_max_bytes=4096)
    big = np.zeros(800, np.float32)
    for i in range(5):
        log.append(wal.UPDATE, "s", (big + i,))
    assert log.stats()["segments"] >= 3
    removed = log.truncate(log.last_seq)  # everything retired
    assert removed >= 1
    assert log.read_tail(0) == []
    assert log.last_seq == 5
    log.close()
    # the empty successor segment pins the floor across a restart
    log2 = _log(tmp_path)
    assert log2.last_seq == 5
    assert log2.append(wal.UPDATE, "s", (big,)) == 6


def test_truncate_is_fenced_and_idempotent(tmp_path):
    log = _log(tmp_path, segment_max_bytes=4096)
    big = np.zeros(800, np.float32)
    for i in range(5):
        log.append(wal.UPDATE, "s", (big + i,))
    fence = 2
    log.truncate(fence)
    # records above the fence survive any truncation
    assert [r.seq for r in log.read_tail(fence)] == [3, 4, 5]
    log.truncate(fence)  # idempotent
    assert [r.seq for r in log.read_tail(fence)] == [3, 4, 5]


def test_truncate_holds_back_to_retain_floor(tmp_path):
    """Regression: with a standby streaming this journal (retain_seq
    pinned to its ship cursor), a checkpoint fence must not delete
    records the standby has not streamed — the effective truncation
    fence is min(checkpoint fence, retain floor)."""
    log = _log(tmp_path, segment_max_bytes=4096)
    big = np.zeros(800, np.float32)
    for i in range(5):
        log.append(wal.UPDATE, "s", (big + i,))
    log.retain_seq = 2  # standby has streamed through seq 2
    log.truncate(log.last_seq)  # checkpoint fence covers everything
    # records above the retain floor survive, so the standby can still
    # stream them — no replication gap
    assert [r.seq for r in log.stream_since(2)] == [3, 4, 5]
    assert log.first_seq() <= 3
    # releasing the floor lets the next truncation finish the job
    log.retain_seq = None
    log.truncate(5)
    assert log.first_seq() == 6 and log.last_seq == 5


def test_stream_since_tolerates_concurrently_truncated_segment(tmp_path):
    """Regression: a segment os.remove'd between the snapshot of the
    segment list and the open (a racing auto-checkpoint truncate) must
    not crash the replication read — and the returned batch stays
    contiguous so the consumer can detect the gap instead of silently
    leaping it."""
    log = _log(tmp_path, segment_max_bytes=4096)
    big = np.zeros(1200, np.float32)  # ~4.8KB payload: one frame per segment
    for i in range(4):
        log.append(wal.UPDATE, "s", (big + i,))
    # simulate the race: the first snapshotted segment vanishes from disk
    # behind the reader's back (the in-memory segment list still has it)
    os.remove(log._segments[0].path)
    records = log.stream_since(0)
    assert [r.seq for r in records] == [2, 3, 4]  # no crash, prefix gone
    # the gap is visible to the consumer: first record leaps the cursor
    assert records[0].seq > 0 + 1

    # a MIDDLE segment vanishing truncates the stream at the gap instead
    # of shipping records that leap it
    os.remove(log._segments[2].path)
    records = log.stream_since(1)
    assert [r.seq for r in records] == [2]  # stops before the hole


def test_first_seq_tracks_truncation(tmp_path):
    log = _log(tmp_path, segment_max_bytes=4096)
    assert log.first_seq() == 1  # empty journal: next appendable seq
    big = np.zeros(800, np.float32)
    for i in range(5):
        log.append(wal.UPDATE, "s", (big + i,))
    assert log.first_seq() == 1
    log.truncate(2)
    assert log.first_seq() > 1  # the retired prefix is gone
    log.truncate(5)
    assert log.first_seq() == 6  # everything retired: last_seq + 1


def test_ensure_seq_raises_floor_only(tmp_path):
    log = _log(tmp_path)
    log.ensure_seq(40)
    assert log.last_seq == 40
    log.ensure_seq(10)
    assert log.last_seq == 40
    assert log.append(wal.UPDATE, "s", (np.zeros(2, np.float32),)) == 41


# ---------------------------------------------------------------- surface
def test_stats_and_telemetry_surface(tmp_path):
    telemetry.reset_counters()
    log = _log(tmp_path)
    with telemetry.instrument() as t:
        _append_updates(log, 3)
    stats = log.stats()
    assert stats["appends"] == 3 and stats["last_seq"] == 3
    assert stats["fsyncs"] == 3 and stats["fsync_us_p95"] >= stats["fsync_us_p50"] >= 0
    spans = t.spans(name="journal", kind="append")
    assert len(spans) == 3 and all(s.attrs["nbytes"] > 0 for s in spans)
    counters = telemetry.snapshot()
    assert counters["journal:append"] == 3
    assert counters["journal:bytes"] == stats["bytes"]


def test_fsync_off_still_durable_to_process_kill(tmp_path):
    log = _log(tmp_path, fsync=False)
    _append_updates(log, 2)
    assert log.stats()["fsyncs"] == 0
    log.close()
    assert _log(tmp_path).last_seq == 2  # OS buffers survive a process exit


def test_wal_kill_switch(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_WAL", "0")
    assert not wal.wal_enabled()
    monkeypatch.setenv("METRICS_TPU_WAL", "1")
    assert wal.wal_enabled()
    monkeypatch.delenv("METRICS_TPU_WAL")
    assert wal.wal_enabled()


# ---------------------------------------------------------------- epoch fence
def test_epoch_file_roundtrip_and_monotonicity(tmp_path):
    d = str(tmp_path / "wal")
    assert wal.read_epoch(d) == 0  # never fenced
    assert wal.fence_epoch(d, 3) == 3
    assert wal.read_epoch(d) == 3
    assert wal.fence_epoch(d, 1) == 3  # a fence never lowers
    assert wal.fence_epoch(d, 7) == 7


def test_open_claims_higher_epoch_and_rejects_lower(tmp_path):
    log = _log(tmp_path, epoch=2)
    _append_updates(log, 2)
    log.close()
    assert wal.read_epoch(str(tmp_path / "wal")) == 2
    with pytest.raises(wal.StaleEpochError):
        _log(tmp_path, epoch=1)  # the zombie is refused at open
    # equal epoch reopens fine (same owner restarting)
    assert _log(tmp_path, epoch=2).last_seq == 2


def test_fence_locks_out_live_writer(tmp_path):
    """The failover sequence: a peer fences the directory while the old
    writer is still up; the zombie's next append/truncate raises."""
    zombie = _log(tmp_path, epoch=1)
    _append_updates(zombie, 3)
    wal.fence_epoch(str(tmp_path / "wal"), 2)  # peer takes over
    with pytest.raises(wal.StaleEpochError):
        _append_updates(zombie, 1, start=3)
    with pytest.raises(wal.StaleEpochError):
        zombie.truncate(2)
    # the peer at the fenced epoch sees every pre-fence record
    peer = _log(tmp_path, epoch=2)
    assert peer.last_seq == 3
    _append_updates(peer, 1, start=3)
    assert peer.last_seq == 4


def test_epoch_zero_is_unfenced_legacy_mode(tmp_path):
    """Single-host journals (epoch 0, the default) never write an EPOCH
    file and never check one — zero-cost when the fabric is not in play."""
    log = _log(tmp_path)
    _append_updates(log, 2)
    assert not os.path.exists(str(tmp_path / "wal" / "EPOCH"))
    assert log.stats()["epoch"] == 0


def test_journal_dir_recreated_after_disappearing(tmp_path):
    """First-boot self-heal: appends recreate a journal directory whose
    chain vanished after construction instead of raising."""
    import shutil

    log = _log(tmp_path)
    shutil.rmtree(str(tmp_path / "wal"))
    _append_updates(log, 1)
    assert log.last_seq == 1


# ------------------------------------------------------------- cross-package
def _records_equal(a, b):
    assert [(r.seq, r.kind, r.session, r.rid) for r in a] == [(r.seq, r.kind, r.session, r.rid) for r in b]
    for x, y in zip(a, b):
        assert len(x.args) == len(y.args)
        for u, v in zip(x.args, y.args):
            assert isinstance(u, np.ndarray) and isinstance(v, np.ndarray)
            assert u.dtype == v.dtype and u.shape == v.shape and u.tobytes() == v.tobytes()
        assert x.kwargs.keys() == y.kwargs.keys()
        for k in x.kwargs:
            u, v = x.kwargs[k], y.kwargs[k]
            if isinstance(u, np.ndarray):
                assert u.dtype == v.dtype and u.tobytes() == v.tobytes()
            else:
                assert u == v and type(u) is type(v)


def _write_stream(module, directory, to_array):
    log = module.WriteAheadLog(directory, owner="test", segment_max_bytes=4096)
    rng = np.random.RandomState(7)
    for i in range(12):
        log.append(module.UPDATE, f"s{i % 3}", (to_array(rng.rand(40, 5).astype(np.float32)),
                                                to_array(rng.randint(0, 5, 40).astype(np.int32))),
                   {"flag": bool(i % 2), "k": i}, request_id=100 + i)
    log.append(module.DROP, "s1", drop_seq=4, drop_cause="queue-full-shed")
    log.append(module.CLOSE, "s2")
    log.append(module.RESET, "s0")
    log.close()


def test_jax_journal_reads_in_the_port(tmp_path):
    import jax.numpy as jnp

    d = str(tmp_path / "wal")
    _write_stream(jwal, d, jnp.asarray)
    ours = wal.WriteAheadLog(d, owner="test", segment_max_bytes=4096)
    theirs = jwal.WriteAheadLog(d, owner="test", segment_max_bytes=4096)
    assert ours.last_seq == theirs.last_seq == 15
    _records_equal(ours.read_tail(0), theirs.read_tail(0))
    _records_equal(ours.read_tail(6), theirs.read_tail(6))
    assert [r.seq for r in ours.stream_since(0)] == [r.seq for r in theirs.stream_since(0)]
    assert 4 not in [r.seq for r in ours.read_tail(0)]  # the DROP resolved its victim away


def test_port_journal_reads_in_the_jax_package(tmp_path):
    d = str(tmp_path / "wal")
    _write_stream(wal, d, torch.from_numpy)  # tensors: journaled as numpy arrays
    theirs = jwal.WriteAheadLog(d, owner="test", segment_max_bytes=4096)
    ours = wal.WriteAheadLog(d, owner="test", segment_max_bytes=4096)
    assert theirs.last_seq == ours.last_seq == 15
    _records_equal(theirs.read_tail(0), ours.read_tail(0))
    # the header's leaf summary names the numpy shapes and dtypes, as the JAX package writes it
    seg = sorted(os.listdir(d))[0]
    data = open(os.path.join(d, seg), "rb").read()
    assert b'"leaves": [[[40, 5], "float32"], [[40], "int32"]]' in data


def test_journal_appended_by_both_packages_stays_one_sequence(tmp_path):
    d = str(tmp_path / "wal")
    _append_updates(wal.WriteAheadLog(d, owner="test"), 3)
    j = jwal.WriteAheadLog(d, owner="test")
    assert j.append(jwal.UPDATE, "s", (np.zeros(2, np.float32),)) == 4
    j.close()
    log = wal.WriteAheadLog(d, owner="test")
    assert log.last_seq == 4 and [r.seq for r in log.read_tail(0)] == [1, 2, 3, 4]


def test_cuda_free_tensor_leaves_journal_as_numpy(tmp_path):
    log = _log(tmp_path)
    log.append(wal.UPDATE, "t", (torch.arange(4, dtype=torch.int32), torch.ones(2, 3)), {"w": torch.tensor(2.0)})
    (rec,) = log.read_tail(0)
    assert [type(a) for a in rec.args] == [np.ndarray, np.ndarray]
    assert rec.args[0].dtype == np.int32 and rec.args[1].shape == (2, 3)
    assert isinstance(rec.kwargs["w"], np.ndarray) and float(rec.kwargs["w"]) == 2.0


@pytest.mark.parametrize("precision", [None, "int8"])
def test_ship_frames_cross_packages(precision):
    rng = np.random.RandomState(3)
    recs = [wal.WalRecord(i + 1, wal.UPDATE, f"s{i}", (rng.rand(600).astype(np.float32),
                                                        rng.randint(0, 9, 600).astype(np.int32)), {"f": True}, rid=i + 1)
            for i in range(3)]
    jrecs = [jwal.WalRecord(*r) for r in recs]
    ours = wal.encode_ship_frame(recs, floor=2, precision=precision)
    theirs = jwal.encode_ship_frame(jrecs, floor=2, precision=precision)
    for frame in (ours, theirs):
        for decoder in (wal.decode_ship_frame, jwal.decode_ship_frame):
            got, floor = decoder(frame)
            assert floor == 2 and [r.seq for r in got] == [1, 2, 3]
            for r, want in zip(got, recs):
                assert r.args[1].tobytes() == want.args[1].tobytes()  # integer leaves: raw, exact
                if precision is None:
                    assert r.args[0].tobytes() == want.args[0].tobytes()
                else:
                    assert np.max(np.abs(r.args[0] - want.args[0])) <= np.max(np.abs(want.args[0])) / 127.0
    assert wal.frame_error_budget(ours) == jwal.frame_error_budget(theirs)
    assert (wal.frame_error_budget(ours) > 0) == (precision == "int8")


@pytest.mark.parametrize("precision", [None, "int8"])
def test_seed_frames_cross_packages_and_refuse_damage(precision):
    rng = np.random.RandomState(4)
    leaves = {"total": rng.rand(64, 300).astype(np.float32), "count": rng.randint(0, 99, (64, 7)).astype(np.int32)}
    ours = wal.encode_seed_frame({k: torch.from_numpy(v) for k, v in leaves.items()}, precision=precision)
    theirs = jwal.encode_seed_frame(leaves, precision=precision)
    assert ours == theirs  # the same bytes on the wire
    for decode in (wal.decode_seed_frame, jwal.decode_seed_frame):
        got = decode(ours)
        assert got["count"].tobytes() == leaves["count"].tobytes()
    with pytest.raises(StateCorruptionError, match="crc"):
        wal.decode_seed_frame(ours[:-1] + bytes([ours[-1] ^ 0xFF]))


def test_stale_epoch_error_is_the_ports_own():
    assert issubclass(wal.StaleEpochError, RuntimeError)
    assert wal.StaleEpochError is not jwal.StaleEpochError
