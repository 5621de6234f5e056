"""Write-ahead update journal for crash-consistent serving.

Port of ``metrics_tpu/wal.py``, whole, with the same bytes on disk: a
journal written by either package reads in the other. Every ``submit()`` of
a journaled :class:`~metrics_tpu_torch.serve.MetricsService` appends one
checksummed, monotonically sequenced record here *before* the request can
be flushed, so the request stream survives a kill at any instruction and
``restore()`` replays the tail that no checkpoint holds.

Frame format (one record)::

    MAGIC  b"MTWL"                        4 bytes
    HEAD   struct "<QBIII"               21 bytes
             seq    u64   monotonic sequence number (never reused)
             kind   u8    UPDATE / DROP / CLOSE / RESET
             hlen   u32   header length in bytes
             plen   u32   payload length in bytes
             crc    u32   crc32 over header bytes + payload bytes
    header JSON: session name, per-leaf [shape, dtype] summary, the wall
           clock ``ts``, the request id ``rid`` (DROP frames carry the
           dropped seq + cause instead of leaves)
    payload: pickled ``(args, kwargs)`` with every array leaf a numpy
           array (a CUDA tensor is copied to the host: one device-to-host
           copy each journaled submit, timed in the request's
           ``journal_us``); empty for DROP/CLOSE/RESET

Records append to segment files ``wal-{first_seq:020d}.seg``. An append is
atomic at frame granularity: write, flush, fsync (unless ``fsync=False`` /
``METRICS_TPU_WAL_FSYNC=0``). On open, a torn frame at the tail of the
**last** segment is discarded and truncated (that submit never returned); a
torn frame anywhere else, or a crc mismatch on a complete frame, raises
:class:`~metrics_tpu_torch.resilience.StateCorruptionError`.

:meth:`WriteAheadLog.read_tail` returns the records above a checkpoint's
fence with ``DROP`` frames resolved away; :meth:`WriteAheadLog.truncate`
deletes segments wholly at or below a fence. The payload codec is
:mod:`pickle` behind the frame crc: a private format that this program
writes and reads.

Epoch fencing: a journal directory carries an ``EPOCH`` file, the highest
ownership epoch granted for it. A writer below it raises
:class:`StaleEpochError` on open, append and truncate; :func:`fence_epoch`
lets a peer fence the directory before it replays it.

Replication frames (``MTQF``): :func:`encode_ship_frame` /
:func:`encode_seed_frame` carry shipped records and bulk state as crc-guarded
pickles, float leaves on the block-wise int8 codec of
:mod:`metrics_tpu_torch.quant` (``np_encode_q8``) when asked for, and
:class:`StandbyReplica` applies them to a warm journal-less service.

Env knobs:

================================ =======================================
``METRICS_TPU_WAL=0``            kill switch: ``MetricsService`` skips
                                 journaling entirely (checkpoint-only)
``METRICS_TPU_WAL_FSYNC=0``      skip the per-append fsync (a host crash
                                 can lose OS-buffered frames; a process
                                 kill alone cannot)
``METRICS_TPU_WAL_SEGMENT_BYTES`` segment roll threshold (default 4 MiB)
================================ =======================================
"""
import json
import os
import pickle
import struct
import threading
import time
import zlib
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

import torch

from metrics_tpu_torch import faults, quant, resilience, telemetry

__all__ = [
    "WriteAheadLog",
    "WalRecord",
    "StandbyReplica",
    "StaleEpochError",
    "wal_enabled",
    "read_epoch",
    "fence_epoch",
    "UPDATE",
    "DROP",
    "CLOSE",
    "RESET",
]

# record kinds (u8 in the frame header)
UPDATE = 1  # one submit(): payload is the (args, kwargs) tree
DROP = 2    # admission shed / deadline expiry of an earlier UPDATE seq
CLOSE = 3   # close_session(name)
RESET = 4   # reset_session(name)

_KIND_NAMES = {UPDATE: "update", DROP: "drop", CLOSE: "close", RESET: "reset"}

_MAGIC = b"MTWL"
_HEAD = struct.Struct("<QBIII")  # seq, kind, hlen, plen, crc
_FRAME_OVERHEAD = len(_MAGIC) + _HEAD.size

_DEFAULT_SEGMENT_BYTES = 4 * 1024 * 1024

# per-directory ownership fence (multi-host failover): the highest epoch
# ever granted write ownership of this journal directory
_EPOCH_FILE = "EPOCH"


class StaleEpochError(RuntimeError):
    """A write arrived from an epoch below the directory's ownership fence
    — the writer is a zombie shard whose partition a peer already claimed
    (:func:`fence_epoch`). The write was refused before touching disk."""


def read_epoch(directory: str) -> int:
    """The directory's fenced ownership epoch (0 when never fenced)."""
    try:
        with open(os.path.join(directory, _EPOCH_FILE)) as f:
            return int(json.load(f)["epoch"])
    except (FileNotFoundError, NotADirectoryError):
        return 0
    except Exception as err:  # noqa: BLE001 - torn write of the tiny file
        raise resilience.StateCorruptionError(
            f"journal epoch fence {os.path.join(directory, _EPOCH_FILE)!r} is "
            f"unreadable: {err}"
        ) from err


def fence_epoch(directory: str, epoch: int) -> int:
    """Advance the directory's ownership fence to at least ``epoch``
    (atomic write + replace; the fence never lowers). Returns the fenced
    epoch. A peer taking over a dead shard fences FIRST, then replays —
    after this returns, any append from a writer opened at a lower epoch
    raises :class:`StaleEpochError`."""
    os.makedirs(directory, exist_ok=True)
    current = read_epoch(directory)
    fenced = max(current, int(epoch))
    if fenced > current or current == 0:
        path = os.path.join(directory, _EPOCH_FILE)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"epoch": fenced}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    return fenced


def wal_enabled() -> bool:
    """Journal kill switch (env ``METRICS_TPU_WAL``, default on). Off
    restores checkpoint-only durability exactly — no segment files
    are written even when a ``journal_dir`` is configured."""
    return os.environ.get("METRICS_TPU_WAL", "1").strip().lower() not in ("0", "false", "off")


def _fsync_default() -> bool:
    return os.environ.get("METRICS_TPU_WAL_FSYNC", "1").strip().lower() not in ("0", "false", "off")


def _segment_bytes_default() -> int:
    try:
        return max(4096, int(os.environ.get("METRICS_TPU_WAL_SEGMENT_BYTES", str(_DEFAULT_SEGMENT_BYTES))))
    except ValueError:
        return _DEFAULT_SEGMENT_BYTES


class WalRecord(NamedTuple):
    """One replayable journal record (DROP frames are resolved away by
    :meth:`WriteAheadLog.read_tail` and never surface here)."""

    seq: int
    kind: int
    session: str
    args: Tuple
    kwargs: Dict[str, Any]
    # request id minted by MetricsService.submit() at admission time; 0 for
    # pre-flight-recorder journals and non-UPDATE kinds. Replay reuses it so
    # a request keeps its identity across a crash.
    rid: int = 0
    # wall-clock append time. Frames written before the ts header existed
    # decode with ``ts=None``. Advisory ONLY: wall clocks skew and step
    # (the ``clock-skew`` fault), so time-travel reads pick a ts *boundary*
    # but always order and fence by ``seq``.
    ts: Optional[float] = None

    @property
    def kind_name(self) -> str:
        return _KIND_NAMES.get(self.kind, str(self.kind))


def _tree_map(fn: Any, tree: Any) -> Any:
    """``fn`` over the leaves of nested tuples, lists and dicts (a dict's
    keys in sorted order, as ``jax.tree_util`` walks them)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def _host(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()  # a CUDA tensor: one device-to-host copy
    return np.asarray(x) if hasattr(x, "dtype") else x


def _to_numpy(tree: Any) -> Any:
    """Array leaves (tensors, on any device, and numpy arrays) become host
    numpy arrays; Python scalars and strings pass through, so that static
    kwargs replay with their types. A frame is therefore a pickle of numpy
    trees, as the JAX package writes it: a journal of either package reads
    in the other."""
    return _tree_map(_host, tree)


def _leaf_summary(args: Tuple, kwargs: Dict[str, Any]) -> List[List[Any]]:
    flat: List[Any] = []
    _tree_map(flat.append, (args, kwargs))
    return [
        [list(np.shape(x)), str(x.dtype)] for x in flat if hasattr(x, "dtype")
    ]


class _Segment(NamedTuple):
    """Init-scan summary of one on-disk segment file."""

    path: str
    first_seq: int  # from the file name: seq of the first frame it holds
    last_seq: int   # seq of its last complete frame (first_seq - 1 if empty)
    nbytes: int     # valid byte length (torn tail already excluded)


class WriteAheadLog:
    """Append-only, segmented, crc-framed journal under one directory.

    Args:
        directory: segment directory (created if missing). One journal
            per directory — two live writers would interleave frames.
        owner: telemetry owner label for ``journal`` spans.
        fsync: fsync after every append (default from
            ``METRICS_TPU_WAL_FSYNC``). Off trades host-crash durability
            for speed; process-kill durability is unaffected.
        segment_max_bytes: roll to a new segment past this size (default
            from ``METRICS_TPU_WAL_SEGMENT_BYTES``).
        epoch: ownership epoch this writer opens at. Opening above the
            directory's fence claims it (:func:`fence_epoch`); opening
            *below* it raises :class:`StaleEpochError` immediately — a
            demoted host must not reattach to a partition it lost.

    Thread-safe: one lock serializes appends (the fsync dominates, so
    finer grain buys nothing).
    """

    def __init__(
        self,
        directory: str,
        *,
        owner: str = "wal",
        fsync: Optional[bool] = None,
        segment_max_bytes: Optional[int] = None,
        epoch: int = 0,
    ) -> None:
        self.directory = directory
        self.owner = owner
        self.fsync = _fsync_default() if fsync is None else bool(fsync)
        self.segment_max_bytes = (
            _segment_bytes_default() if segment_max_bytes is None else max(4096, int(segment_max_bytes))
        )
        os.makedirs(directory, exist_ok=True)
        self.epoch = int(epoch)
        fenced = read_epoch(directory)
        if self.epoch < fenced:
            raise StaleEpochError(
                f"journal {directory!r} is fenced at epoch {fenced}; refusing "
                f"to open a writer at stale epoch {self.epoch}"
            )
        if self.epoch > fenced:
            fence_epoch(directory, self.epoch)
        self._lock = threading.Lock()
        # replication hold-back: with a standby streaming this journal, the
        # fabric pins this to the standby's ship cursor so a checkpoint
        # fence can never truncate records the standby has not seen yet
        # (None = no consumer; truncate freely)
        self.retain_seq: Optional[int] = None
        # history hold-back: with a checkpoint ladder retained (see
        # serve.HistoryPolicy), the service pins this to the oldest retained
        # rung's fence so no rung's replay tail is ever truncated out from
        # under a time-travel read. Composes with retain_seq by min().
        self.history_floor: Optional[int] = None
        self._active: Optional[Any] = None  # open file handle of the last segment
        self._active_path: Optional[str] = None
        self._fsync_us: deque = deque(maxlen=512)
        self._stats: Dict[str, int] = {
            "appends": 0,
            "bytes": 0,
            "fsyncs": 0,
            "replayed": 0,
            "shipped": 0,
            "truncated_segments": 0,
            "discarded_frames": 0,
            "drops": 0,
        }
        self._segments: List[_Segment] = self._scan()
        self._last_seq = self._segments[-1].last_seq if self._segments else 0

    # ------------------------------------------------------------------ scan
    def _segment_paths(self) -> List[str]:
        try:
            names = sorted(
                n for n in os.listdir(self.directory)
                if n.startswith("wal-") and n.endswith(".seg")
            )
        except FileNotFoundError:
            # a ladder GC / offline scrub emptied the state volume out from
            # under us; an empty journal is the honest answer (the next
            # append re-creates the directory chain)
            return []
        return [os.path.join(self.directory, n) for n in names]

    @staticmethod
    def _name_seq(path: str) -> int:
        base = os.path.basename(path)
        return int(base[len("wal-"):-len(".seg")])

    def _scan(self) -> List[_Segment]:
        """Validate every segment on open: crc-check all frames, assert
        monotonic seqs, discard+truncate a torn tail on the LAST segment
        only. Raises ``StateCorruptionError`` on anything else."""
        paths = self._segment_paths()
        segments: List[_Segment] = []
        expected = None
        for i, path in enumerate(paths):
            is_last = i == len(paths) - 1
            first_seq = self._name_seq(path)
            if expected is not None and first_seq != expected:
                raise resilience.StateCorruptionError(
                    f"journal segment {os.path.basename(path)} starts at seq {first_seq}, "
                    f"expected {expected} (missing or reordered segment)"
                )
            last_seq = first_seq - 1
            with open(path, "rb") as f:
                data = f.read()
            offset = 0
            while offset < len(data):
                frame = self._parse_frame(data, offset, path)
                if frame is None:  # torn frame
                    if not is_last:
                        raise resilience.StateCorruptionError(
                            f"journal segment {os.path.basename(path)} has a torn frame at "
                            f"offset {offset} but is not the last segment — the journal is corrupt"
                        )
                    # a crash tore the in-flight append; that submit never
                    # returned, so the frame legitimately does not exist
                    with open(path, "r+b") as f:
                        f.truncate(offset)
                    self._stats["discarded_frames"] += 1
                    break
                seq, _, _, _, frame_len = frame
                if seq != last_seq + 1:
                    raise resilience.StateCorruptionError(
                        f"journal segment {os.path.basename(path)} frame at offset {offset} "
                        f"carries seq {seq}, expected {last_seq + 1} (sequence gap)"
                    )
                last_seq = seq
                offset += frame_len
            segments.append(_Segment(path, first_seq, last_seq, min(offset, len(data))))
            expected = last_seq + 1
        return segments

    def _parse_frame(self, data: bytes, offset: int, path: str):
        """Parse one frame at ``offset``. Returns ``(seq, kind, header,
        payload, frame_len)``; ``None`` for an incomplete (torn) frame;
        raises on a complete-but-corrupt one."""
        if offset + _FRAME_OVERHEAD > len(data):
            return None
        if data[offset:offset + len(_MAGIC)] != _MAGIC:
            raise resilience.StateCorruptionError(
                f"journal segment {os.path.basename(path)} frame at offset {offset} "
                "has a bad magic — the journal is corrupt"
            )
        seq, kind, hlen, plen, crc = _HEAD.unpack_from(data, offset + len(_MAGIC))
        body_start = offset + _FRAME_OVERHEAD
        if body_start + hlen + plen > len(data):
            return None
        body = data[body_start:body_start + hlen + plen]
        if faults.crc(body) != crc:
            raise resilience.StateCorruptionError(
                f"journal segment {os.path.basename(path)} frame seq {seq} failed its "
                "crc32 check — refusing to replay a corrupt record"
            )
        header = json.loads(body[:hlen].decode())
        payload = body[hlen:hlen + plen]
        return seq, kind, header, payload, _FRAME_OVERHEAD + hlen + plen

    # ---------------------------------------------------------------- append
    @property
    def last_seq(self) -> int:
        """High-water sequence number (0 before the first append)."""
        return self._last_seq

    def first_seq(self) -> int:
        """Lowest sequence number still readable from disk
        (``last_seq + 1`` once truncation has retired every frame). A
        replication consumer whose cursor sits below ``first_seq() - 1``
        has a gap — records it never streamed were truncated — and must
        re-seed by bulk state transfer instead of streaming."""
        with self._lock:
            if self._segments:
                return self._segments[0].first_seq
            return self._last_seq + 1

    def ensure_seq(self, floor: int) -> None:
        """Raise the sequence floor to at least ``floor`` (restore() calls
        this with the checkpoint fence so a journal whose segments were all
        truncated can never re-issue fenced sequence numbers)."""
        with self._lock:
            if floor > self._last_seq:
                self._last_seq = int(floor)

    def check_epoch(self) -> None:
        """Raise :class:`StaleEpochError` if a peer fenced the directory
        above this writer's epoch (i.e. this process is a zombie). Re-read
        on every durable write: one ~µs file read next to an fsync."""
        fenced = read_epoch(self.directory)
        if self.epoch < fenced:
            raise StaleEpochError(
                f"journal {self.directory!r} was fenced at epoch {fenced} by a "
                f"peer; this writer (epoch {self.epoch}) is a zombie — write refused"
            )

    def _open_segment(self, first_seq: int) -> None:
        # self-heal the directory chain: a fresh shard host may mount its
        # state volume empty after first boot (zero-config contract)
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, f"wal-{first_seq:020d}.seg")
        self._active = open(path, "ab")
        self._active_path = path
        if not any(s.path == path for s in self._segments):
            self._segments.append(_Segment(path, first_seq, first_seq - 1, 0))

    def _timed_fsync(self, f: Any) -> None:
        if not self.fsync:
            return
        t0 = time.perf_counter()
        os.fsync(f.fileno())
        self._fsync_us.append((time.perf_counter() - t0) * 1e6)
        self._stats["fsyncs"] += 1

    def append(
        self,
        kind: int,
        session: str,
        args: Tuple = (),
        kwargs: Optional[Dict[str, Any]] = None,
        *,
        drop_seq: Optional[int] = None,
        drop_cause: Optional[str] = None,
        request_id: Optional[int] = None,
    ) -> int:
        """Durably append one record; returns its sequence number. The
        record is on disk (fsync'd, unless disabled) before this returns —
        the contract ``submit()`` relies on. ``DROP`` frames carry the
        dropped seq + cause in the header and no payload. ``request_id``
        (UPDATE frames) persists the flight-recorder rid so replayed
        requests keep their identity."""
        kwargs = kwargs or {}
        self.check_epoch()
        header: Dict[str, Any] = {"session": session}
        if self.epoch:
            header["epoch"] = self.epoch
        # wall-clock header (versioned: readers use header.get("ts")). The
        # clock-skew fault steps the sampled clock backwards — appended ts
        # values go non-monotonic exactly like a stepped NTP host, which is
        # why every consumer must order by seq, never by ts.
        ts = time.time()
        if faults.should_fire("clock-skew"):
            ts -= float(faults.fault_params("clock-skew").get("skew_s", 3600.0))
        header["ts"] = round(ts, 6)
        if kind == UPDATE:
            args = _to_numpy(args)
            kwargs = _to_numpy(kwargs)
            header["leaves"] = _leaf_summary(args, kwargs)
            if request_id is not None:
                header["rid"] = int(request_id)
            payload = pickle.dumps((args, kwargs))
        elif kind == DROP:
            header["drop"] = int(drop_seq if drop_seq is not None else 0)
            if drop_cause:
                header["cause"] = drop_cause
            payload = b""
        else:
            payload = b""
        hbytes = json.dumps(header).encode()
        body = hbytes + payload

        t0 = telemetry.clock()
        with self._lock:
            seq = self._last_seq + 1
            frame = (
                _MAGIC
                + _HEAD.pack(seq, kind, len(hbytes), len(payload), faults.crc(body))
                + body
            )
            if self._active is None:
                self._open_segment(seq)
            f = self._active
            if faults.crash_will_fire("mid-journal-append"):
                # genuine torn tail: half a frame reaches disk, then SIGKILL
                f.write(frame[: max(1, len(frame) // 2)])
                f.flush()
                self._timed_fsync(f)
                faults.crash_point("mid-journal-append", self.owner)
            f.write(frame)
            f.flush()
            self._timed_fsync(f)
            faults.crash_point("mid-journal-append", self.owner)
            self._last_seq = seq
            seg = self._segments[-1]
            self._segments[-1] = seg._replace(last_seq=seq, nbytes=seg.nbytes + len(frame))
            self._stats["appends"] += 1
            self._stats["bytes"] += len(frame)
            if kind == DROP:
                self._stats["drops"] += 1
            roll = self._segments[-1].nbytes >= self.segment_max_bytes
            if roll:
                f.close()
                self._active = None
                self._active_path = None
        extra = {} if request_id is None else {"rid": int(request_id)}
        telemetry.emit(
            "journal", self.owner, "append", t0=t0, stream="serve",
            seq=seq, record=_KIND_NAMES.get(kind, str(kind)), nbytes=len(frame),
            **extra,
        )
        if roll:
            # next append opens wal-{seq+1}.seg; opening lazily keeps an
            # idle service from leaving empty segments behind
            pass
        return seq

    # ----------------------------------------------------------------- read
    def read_tail(self, after_seq: int = 0) -> List[WalRecord]:
        """All replayable records with ``seq > after_seq`` in order, with
        DROP frames resolved: an update the live process shed or expired is
        excluded, exactly as it was excluded from live state."""
        frames: List[Tuple[int, int, Dict[str, Any], bytes]] = []
        dropped: set = set()
        with self._lock:
            segments = list(self._segments)
        for seg in segments:
            if seg.last_seq <= after_seq:
                continue
            try:
                with open(seg.path, "rb") as f:
                    data = f.read()
            except FileNotFoundError:
                # retired by a concurrent truncate (or a ladder GC) between
                # the snapshot and the open. A fenced replay never needed
                # its frames; an unfenced one must not leap the gap — stop
                # at the discontinuity and return the contiguous prefix.
                if frames:
                    break
                continue
            offset = 0
            while offset < len(data):
                frame = self._parse_frame(data, offset, seg.path)
                if frame is None:
                    break  # live-writer tail (concurrent append); scan() handled crashes
                seq, kind, header, payload, frame_len = frame
                offset += frame_len
                if kind == DROP:
                    dropped.add(int(header.get("drop", 0)))
                    continue
                if seq <= after_seq:
                    continue
                frames.append((seq, kind, header, payload))
        records: List[WalRecord] = []
        for seq, kind, header, payload in frames:
            if kind == UPDATE and seq in dropped:
                continue
            if kind == UPDATE:
                args, kwargs = pickle.loads(payload)
            else:
                args, kwargs = (), {}
            records.append(WalRecord(
                seq, kind, str(header.get("session", "")), args, kwargs,
                rid=int(header.get("rid", 0)), ts=header.get("ts"),
            ))
        with self._lock:
            self._stats["replayed"] += len(records)
        return records

    # ---------------------------------------------------------- replication
    def stream_since(self, after_seq: int = 0) -> List[WalRecord]:
        """Replication stream: every record with ``seq > after_seq``, in
        order, INCLUDING unresolved ``DROP`` frames — a ``DROP`` record
        carries the cancelled seq as ``args[0]`` and its cause under
        ``kwargs["cause"]``. Unlike :meth:`read_tail`, drops are NOT
        resolved here: a drop may ship in a *later* batch than the update
        it cancels, so resolution belongs to the receiver
        (:class:`StandbyReplica` holds unresolved updates back until the
        primary's replication floor passes them). Reads the sealed
        segments plus the active tail; an incomplete in-flight frame at
        the very end is skipped (it ships with the next batch).

        Safe against a concurrent :meth:`truncate` (the flush worker's
        auto-checkpoint races replication reads): a snapshotted segment
        removed before it could be opened is skipped, and the stream
        stops at the first sequence discontinuity so the returned batch
        is always contiguous — the caller detects the resulting gap
        (``records[0].seq`` vs its cursor, or :meth:`first_seq`) and
        re-seeds the consumer instead of leaping truncated records."""
        out: List[WalRecord] = []
        with self._lock:
            segments = list(self._segments)
        prev: Optional[int] = None
        for seg in segments:
            if seg.last_seq <= after_seq:
                continue
            try:
                with open(seg.path, "rb") as f:
                    data = f.read()
            except FileNotFoundError:
                # truncated between the snapshot and the open. Anything it
                # held is a gap: if earlier records were already collected,
                # later segments would leap it — stop and ship the prefix.
                if prev is not None:
                    break
                continue
            gap = False
            offset = 0
            while offset < len(data):
                frame = self._parse_frame(data, offset, seg.path)
                if frame is None:
                    break  # live-writer tail; ships next batch
                seq, kind, header, payload, frame_len = frame
                offset += frame_len
                if seq <= after_seq:
                    continue
                if prev is not None and seq != prev + 1:
                    gap = True
                    break
                prev = seq
                if kind == UPDATE:
                    args, kwargs = pickle.loads(payload)
                elif kind == DROP:
                    args = (int(header.get("drop", 0)),)
                    kwargs = {"cause": header.get("cause", "")}
                else:
                    args, kwargs = (), {}
                out.append(WalRecord(
                    seq, kind, str(header.get("session", "")), args, kwargs,
                    rid=int(header.get("rid", 0)), ts=header.get("ts"),
                ))
            if gap:
                break
        with self._lock:
            self._stats["shipped"] += len(out)
        return out

    # ------------------------------------------------------------- truncate
    def truncate(self, upto_seq: int) -> int:
        """Delete segments wholly retired by a checkpoint fence at
        ``upto_seq``; returns how many were removed. If the active segment
        itself is fully retired, a fresh (empty) successor segment is
        created *first* — its name pins the sequence floor — so a crash at
        any point leaves a journal that still opens with the right
        ``last_seq``. Idempotent: replay is fenced, so a half-truncated
        journal wastes disk, never correctness.

        With :attr:`retain_seq` set (a standby is streaming this journal;
        the fabric pins it to the ship cursor after every ship), the
        effective fence is ``min(upto_seq, retain_seq)`` — a checkpoint
        can never delete records the standby has not streamed, so the
        replication cursor never silently leaps truncated records.
        :attr:`history_floor` (the oldest retained checkpoint-ladder
        rung's fence) composes the same way, so every retained rung keeps
        a contiguous replay tail for time-travel reads."""
        removed = 0
        upto_seq = int(upto_seq)
        for floor in (self.retain_seq, self.history_floor):
            if floor is not None:
                upto_seq = min(upto_seq, int(floor))
        self.check_epoch()
        t0 = telemetry.clock()
        with self._lock:
            retire = [s for s in self._segments if s.last_seq <= upto_seq]
            keep = [s for s in self._segments if s.last_seq > upto_seq]
            if not retire:
                return 0
            if not keep:
                # every frame is retired: open the successor segment before
                # unlinking anything so the sequence floor survives a crash
                if self._active is not None:
                    self._active.close()
                    self._active = None
                    self._active_path = None
                self._segments = []
                self._open_segment(self._last_seq + 1)
                keep = list(self._segments)
            for seg in retire:
                if seg.path == self._active_path:
                    continue  # unreachable once keep includes the successor
                faults.crash_point("mid-truncate", self.owner)
                try:
                    os.remove(seg.path)
                except FileNotFoundError:
                    pass  # a prior half-truncation already removed it
                removed += 1
            self._segments = keep
            self._stats["truncated_segments"] += removed
        telemetry.emit(
            "journal", self.owner, "truncate", t0=t0, stream="serve",
            segments=removed, fence=upto_seq,
        )
        return removed

    # ---------------------------------------------------------------- admin
    def close(self) -> None:
        with self._lock:
            if self._active is not None:
                self._active.close()
                self._active = None
                self._active_path = None

    def stats(self) -> Dict[str, Any]:
        """Journal counters + fsync latency percentiles (µs) for
        ``telemetry_snapshot()`` / ``tools/trace_report.py``."""
        with self._lock:
            out: Dict[str, Any] = dict(self._stats)
            out["last_seq"] = self._last_seq
            out["segments"] = len(self._segments)
            out["epoch"] = self.epoch
            lat = sorted(self._fsync_us)
        def pct(q: float) -> float:
            if not lat:
                return 0.0
            idx = min(len(lat) - 1, max(0, int(round(q / 100.0 * (len(lat) - 1)))))
            return round(lat[idx], 1)
        out["fsync_us_p50"] = pct(50)
        out["fsync_us_p95"] = pct(95)
        return out


# ------------------------------------------------------- replication frames
#
# The quantized replication wire: when the fabric opts into
# ``replication_precision="int8"``, ship batches and bulk re-seed state
# cross shard boundaries as self-describing frames instead of in-process
# object handoff — MAGIC + kind byte + crc32(payload) + pickled payload,
# with float array leaves negotiated down to the block-wise int8 codec
# (:mod:`metrics_tpu_torch.quant`) and integer / bool / opted-out leaves kept
# raw, so exact state stays lossless. The crc guard turns any in-flight
# bit damage (including the injected ``quant-corruption`` fault) into a
# :class:`~metrics_tpu_torch.resilience.StateCorruptionError` instead of a
# silently divergent standby.

FRAME_MAGIC = b"MTQF"
FRAME_SHIP = 1
FRAME_SEED = 2
_FRAME_KIND_NAMES = {FRAME_SHIP: "ship", FRAME_SEED: "seed"}
_ARR_MARK = "__mtqf_arr__"


def _encode_array(arr: Any, precision: Optional[str], quantize_ok: bool = True) -> Tuple:
    """Per-leaf wire negotiation: float arrays ride the block-wise int8
    codec when ``precision`` asks for it (and it actually shrinks the
    leaf); everything else crosses as raw bytes — exact."""
    a = np.asarray(arr)
    if (
        precision == "int8"
        and quantize_ok
        and a.dtype.kind == "f"
        and quant.quant_enabled()
    ):
        block = quant.default_block()
        codec = quant.QuantCodec("q8")
        if quant.bucket_wire_nbytes(int(a.size), codec, block) < a.nbytes:
            qb, sb = quant.np_encode_q8(a, block=block)
            return ("q8", a.dtype.str, tuple(a.shape), block, qb, sb)
    return ("raw", a.dtype.str, tuple(a.shape), a.tobytes())


def _decode_array(enc: Tuple) -> np.ndarray:
    if enc[0] == "q8":
        _tag, dt, shape, block, qb, sb = enc
        n = int(np.prod(shape, dtype=np.int64))
        vals = quant.np_decode_q8(qb, sb, n, block=block)
        return vals.reshape(shape).astype(np.dtype(dt))
    _tag, dt, shape, raw = enc
    return np.frombuffer(raw, dtype=np.dtype(dt)).reshape(shape)


def _encode_tree(x: Any, precision: Optional[str]) -> Any:
    if isinstance(x, (list, tuple)):
        return type(x)(_encode_tree(v, precision) for v in x)
    if isinstance(x, dict):
        return {k: _encode_tree(v, precision) for k, v in x.items()}
    if hasattr(x, "dtype"):
        return (_ARR_MARK,) + _encode_array(x, precision)
    return x


def _decode_tree(x: Any) -> Any:
    if isinstance(x, tuple) and x and x[0] == _ARR_MARK:
        return _decode_array(x[1:])
    if isinstance(x, (list, tuple)):
        return type(x)(_decode_tree(v) for v in x)
    if isinstance(x, dict):
        return {k: _decode_tree(v) for k, v in x.items()}
    return x


def _frame(kind: int, payload: bytes) -> bytes:
    return (
        FRAME_MAGIC
        + bytes([kind])
        + struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF)
        + payload
    )


def _check_frame(data: bytes, expect_kind: int) -> bytes:
    """Validate a wire frame; raises ``StateCorruptionError`` on any
    damage — a corrupted replication frame must NEVER apply silently."""
    want = _FRAME_KIND_NAMES.get(expect_kind, str(expect_kind))
    if len(data) < 9 or data[:4] != FRAME_MAGIC:
        raise resilience.StateCorruptionError(
            f"replication {want} frame: bad magic/truncated header"
        )
    if data[4] != expect_kind:
        raise resilience.StateCorruptionError(
            f"replication {want} frame: unexpected kind byte {data[4]}"
        )
    (crc,) = struct.unpack("<I", data[5:9])
    payload = data[9:]
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise resilience.StateCorruptionError(
            f"replication {want} frame: crc mismatch (frame damaged in flight)"
        )
    return payload


def encode_ship_frame(records: List["WalRecord"], floor: int, precision: Optional[str] = None) -> bytes:
    """One replication ship batch (records + floor) as a crc-guarded
    wire frame. ``precision="int8"`` quantizes float array args."""
    recs = [
        (
            r.seq, r.kind, r.session,
            _encode_tree(tuple(r.args), precision),
            _encode_tree(dict(r.kwargs), precision),
            r.rid,
        )
        for r in records
    ]
    payload = pickle.dumps(
        {"floor": int(floor), "records": recs},
        protocol=pickle.HIGHEST_PROTOCOL,
    )
    return _frame(FRAME_SHIP, payload)


def decode_ship_frame(data: bytes) -> Tuple[List["WalRecord"], int]:
    """Inverse of :func:`encode_ship_frame`; raises
    ``StateCorruptionError`` on magic/kind/crc damage."""
    obj = pickle.loads(_check_frame(data, FRAME_SHIP))
    records = [
        WalRecord(seq, kind, session, _decode_tree(args), _decode_tree(kwargs), rid)
        for seq, kind, session, args, kwargs, rid in obj["records"]
    ]
    return records, int(obj["floor"])


def encode_seed_frame(
    leaves: Dict[str, Any],
    precision: Optional[str] = None,
    quantize_opt: Optional[Dict[str, bool]] = None,
) -> bytes:
    """Bulk re-seed state transfer: ``{leaf name: stacked array}`` as a
    crc-guarded frame, per-leaf negotiated (``quantize_opt`` carries the
    template's ``add_state(quantize=False)`` opt-outs)."""
    quantize_opt = quantize_opt or {}
    enc = {
        k: _encode_array(v, precision, quantize_opt.get(k, True))
        for k, v in leaves.items()
    }
    return _frame(FRAME_SEED, pickle.dumps(enc, protocol=pickle.HIGHEST_PROTOCOL))


def decode_seed_frame(data: bytes) -> Dict[str, np.ndarray]:
    enc = pickle.loads(_check_frame(data, FRAME_SEED))
    return {k: _decode_array(e) for k, e in enc.items()}


def _collect_q8(x: Any, out: List[Tuple]) -> None:
    if isinstance(x, tuple) and x and x[0] == _ARR_MARK:
        if x[1] == "q8":
            out.append(x[1:])
        return
    if isinstance(x, (list, tuple)):
        for v in x:
            _collect_q8(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _collect_q8(v, out)


def frame_error_budget(data: bytes) -> float:
    """Exact upper bound on the total absolute decode error of one wire
    frame: nearest-rounding q8 is off by at most ``scale / 2`` per
    element, so the bound is the per-block scales weighted by real (un-
    padded) element counts, summed over every quantized array in the
    frame. Raw / integer payloads contribute zero. The fabric
    accumulates this per standby — the tolerance the anti-entropy
    comparand grants lossy leaves, derived from the frames actually
    shipped rather than guessed from state magnitudes."""
    if len(data) < 9:
        raise resilience.StateCorruptionError(
            "replication frame: truncated header"
        )
    kind = data[4]
    obj = pickle.loads(_check_frame(data, kind))
    encs: List[Tuple] = []
    if kind == FRAME_SHIP:
        for _seq, _k, _session, args, kwargs, _rid in obj["records"]:
            _collect_q8(args, encs)
            _collect_q8(kwargs, encs)
    else:
        for e in obj.values():
            if e[0] == "q8":
                encs.append(e)
    total = 0.0
    for _tag, _dt, shape, block, _qb, sb in encs:
        scale = np.frombuffer(sb, dtype=np.float32)
        n = int(np.prod(shape, dtype=np.int64))
        nb = scale.size
        counts = np.full(nb, block, dtype=np.int64)
        if nb:
            counts[-1] = n - (nb - 1) * block
        total += float(np.sum(scale * counts) / 2.0)
    return total


class StandbyReplica:
    """Hot-standby applier: a warm, bit-identical copy of one shard's
    stacked state, maintained by log shipping instead of full replay.

    The primary periodically ships ``stream_since(cursor)`` batches plus
    its **replication floor**
    (:meth:`metrics_tpu_torch.serve.MetricsService.replication_floor` — the seq
    below which every record is resolved: applied to the primary's state
    or durably dropped). Records at or below the floor apply immediately
    through the replica service's replay path; records *above* it are
    held back, because a later ``DROP`` frame (admission shed, deadline
    expiry) may still cancel them — applying eagerly would diverge from
    the primary. Held records apply once a later ship moves the floor
    past them, so ``service`` state always equals
    ``apply(records <= applied_seq)`` — exactly what a fresh
    ``recover()`` would reconstruct at that seq.

    On promotion (the fabric's replicated failover) the peer fences the
    journal epoch, attaches the dead shard's durable directories to the
    warm service, and replays only ``read_tail(applied_seq)`` — the
    unshipped tail — turning failover cost from O(journal) into
    O(replication lag). The anti-entropy pass compares
    :meth:`digest` against the primary's at a common floor and re-seeds
    (:meth:`seed_from`) on divergence.

    ``service`` is a journal-less :class:`~metrics_tpu_torch.serve.MetricsService`
    twin (same template, same shard/rid lattice) built by the fabric; the
    replica never writes the primary's journal or checkpoints.
    """

    def __init__(self, service: Any, *, source_shard: Optional[int] = None) -> None:
        self.service = service
        self.source_shard = source_shard
        # highest seq ever shipped to this replica (the ship cursor)
        self.cursor = 0
        # highest resolved seq applied to the warm state
        self.applied_seq = 0
        # accumulated absolute-error allowance from quantized wire frames
        # (Σ frame_error_budget since the last seed) — 0.0 means the warm
        # copy must be bit-identical
        self.lossy_budget = 0.0
        self._pending: Dict[int, WalRecord] = {}
        self._dropped: set = set()
        self.stats: Dict[str, int] = {
            "ships": 0, "shipped_records": 0, "applied_records": 0,
            "held_records": 0, "reseeds": 0,
        }

    def apply(self, records: List[WalRecord], floor: int) -> int:
        """Ingest one shipped batch and advance the warm state to
        ``floor``. Returns how many records were applied (the rest are
        held back or cancelled by DROP frames)."""
        for rec in records:
            if rec.seq > self.cursor:
                self.cursor = rec.seq
            if rec.kind == DROP:
                target = int(rec.args[0]) if rec.args else 0
                self._dropped.add(target)
                self._pending.pop(target, None)
            elif rec.seq > self.applied_seq and rec.seq not in self._dropped:
                self._pending[rec.seq] = rec
        ready = [
            self._pending.pop(s)
            for s in sorted(self._pending)
            if s <= floor and s not in self._dropped
        ]
        if ready:
            self.service.apply_records(ready)
        # resolved drop targets never resurface below the floor
        self._dropped = {s for s in self._dropped if s > floor}
        if floor > self.applied_seq:
            self.applied_seq = floor
        self.stats["ships"] += 1
        self.stats["shipped_records"] += len(records)
        self.stats["applied_records"] += len(ready)
        self.stats["held_records"] = len(self._pending)
        return len(ready)

    def seed_from(self, primary: Any, floor: int, precision: Optional[str] = None) -> None:
        """Bulk state transfer: install a bit-identical copy of the
        primary's stacked state at its replication floor (standby
        creation, and the anti-entropy re-ship after divergence). The
        ship cursor rewinds to the floor so the next batch re-reads the
        unresolved tail. ``precision="int8"`` routes the transfer
        through the quantized seed frame (lossy for float leaves, exact
        for the rest)."""
        budget = self.service.mirror_state(primary, precision=precision)
        # the seed itself is one lossy round trip; later quantized ships
        # stack their own frame_error_budget on top
        self.lossy_budget = float(budget or 0.0)
        self.applied_seq = int(floor)
        self.cursor = int(floor)
        self._pending.clear()
        self._dropped.clear()
        self.stats["reseeds"] += 1

    def digest(self) -> str:
        """State digest of the warm copy (anti-entropy comparand)."""
        return self.service.state_digest()

    def snapshot(self) -> Dict[str, Any]:
        """Replication gauges for fleet telemetry."""
        return {
            "source_shard": self.source_shard,
            "cursor": self.cursor,
            "applied_seq": self.applied_seq,
            "held": len(self._pending),
            "lossy_budget": self.lossy_budget,
            **dict(self.stats),
        }
