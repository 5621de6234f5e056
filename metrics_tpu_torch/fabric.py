"""Multi-host serving fabric: sharded :class:`MetricsService` with failover.

Port of ``metrics_tpu/fabric.py``. The serving harness
(:mod:`metrics_tpu_torch.serve`) is crash-consistent and
fully traced, but single-process: one host death is total outage, and one
process bounds session count. This module is the horizontal layer over it
— a :class:`ShardedMetricsService` partitions sessions across N
``MetricsService`` shards and makes shard death a replay, not an outage:

* **Consistent-hash routing.** Session ids map to shards through a
  :class:`HashRing` (md5 points, ``vnodes`` virtual nodes per shard), so
  the partition of a session is a pure function of its name — the submit
  path does ZERO cross-shard work: no locks, no collectives, no queues
  shared between shards (the structural check of ``tools/torch_loadgen.py``
  asserts). Each shard owns its stacked state rows, its write-ahead
  journal directory (``shard-<k>/wal``), and its checkpoints
  (``shard-<k>/ckpt``); request ids are minted on a per-shard lattice
  (offset ``k``, stride ``N``) so rids stay globally unique with no
  coordination.
* **Shard death → replay on a peer.** A dead shard (SIGKILL of its host
  process, or the injected ``shard-death`` fault from
  :mod:`metrics_tpu_torch.faults`) is detected by the liveness probe
  (:meth:`ShardedMetricsService.probe`, or lazily at the next route to
  it). Failover (:meth:`ShardedMetricsService.fail_over`) is the
  sequence the WAL already made safe: **fence, then replay** — the
  designated peer (next live shard clockwise on the ring) bumps the dead
  shard's journal epoch (:func:`metrics_tpu_torch.wal.fence_epoch`), builds a
  fresh ``MetricsService`` over the dead shard's directories at the new
  epoch, and ``recover()``\\ s it (checkpoint + sequence-fenced journal
  tail, exactly-once). Any late write from the zombie — a submit or
  checkpoint from the SIGKILLed-but-somehow-alive old host — raises
  :class:`~metrics_tpu_torch.wal.StaleEpochError` at the journal, so the two
  hosts can never interleave frames.
* **Fleet observability.** Every shard's spans carry its shard tag
  (owner ``MetricsService[T]@shard<k>``, ``shard=`` attr on request
  spans); failovers emit a ``failover`` telemetry span with the
  epoch hand-off and the wall time to a recovered first result;
  :meth:`fleet_snapshot` aggregates per-shard breaker state through
  :func:`metrics_tpu_torch.resilience.aggregate_policy_stats`.

Beyond crash failover, membership and degradation are first-class:

* **Elastic membership (planned hand-off).** :meth:`add_shard` /
  :meth:`remove_shard` change capacity with zero kills:
  :meth:`rebalance` drains each source shard (flush + an admission
  fence so no new submits land mid-move), bumps its journal epoch (the
  same zombie fence failover uses — a superseded writer of the moved
  range raises :class:`StaleEpochError`), transfers exactly the
  affected ring arc's session rows to the target, and only then swaps
  ring ownership. Consistent hashing keeps the move minimal — ~1/N of
  the sessions, never a reshuffle — and a moved session's digest is
  bit-identical to an unmoved twin.
* **Hot-standby replication.** With ``standby=True`` each shard ships
  its journal tail (:meth:`metrics_tpu_torch.wal.WriteAheadLog.stream_since`)
  to a :class:`~metrics_tpu_torch.wal.StandbyReplica` designated for its ring
  successor; :meth:`replicate` advances the warm copies. Failover then
  promotes the standby and replays only the *unshipped* tail —
  O(replication lag), not O(journal). :meth:`anti_entropy` checksums
  every standby against its primary at a common replication floor and
  re-seeds divergent copies by bulk state transfer.
* **Gray-failure containment.** The ``shard-slow`` fault class injects
  per-flush latency into one shard (alive, correct, slow); the
  suspicion monitor (:meth:`suspicion_sweep`) reads each shard's SLO
  sketches and quarantines any shard whose served p99 crosses
  ``suspect_p99_multiple`` x its peers' median — drain, fence, and route
  its partition to the successor's standby (failover cause
  ``suspect-slow``). The ``network-partition`` fault class makes a
  shard unreachable while its host keeps running: the fabric fences and
  fails over (cause ``partition``), after which every journaled write
  from the old side raises :class:`StaleEpochError` — exactly one side
  of the partition wins.

Fleet reads (:meth:`ShardedMetricsService.compute_all`, :meth:`rollup`)
are one program over every shard's rows (:func:`metrics_tpu_torch.sync_engine.
build_fleet_read`): on the card one CUDA graph captured per (kind, shard
count, session bucket, input signature, wire signature, the shards' state
buffers), after a warm-up run that serves the read, in thread-local capture
mode; a graph reads the buffers it was captured on, so a shard whose rows
move (failover, a hand-off, a re-seed, a capacity doubling) gets a new one.
Its ``compile`` span is of kind ``fleet-read`` / ``fleet-rollup`` and its cost
entry the registry kernels the capture recorded plus its I/O bytes.

The crash matrix (``tests/test_torch_fabric_crash.py``) SIGKILLs a real
subprocess shard at every crash point and holds the post-failover
``compute_all()`` digest against an uncrashed twin; the open-loop load
harness (``tools/torch_loadgen.py``) drives heavy-tailed, hot-key-skewed
traffic across shards and checks the structural invariants under 2x
overload.
"""
import contextlib
import copy
import hashlib
import os
import statistics
import threading
import time
from bisect import bisect_right
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch import faults, resilience, sync_engine, telemetry, wal
from metrics_tpu_torch.analysis import billing, cost_model
from metrics_tpu_torch.dispatch import _flatten, copy_tensors
from metrics_tpu_torch.ops import registry
from metrics_tpu_torch.serve import (
    _MIN_SESSION_BUCKET,
    MetricsService,
    ValueTicket,
    _lane_value,
    _StackedProgram,
    capture_graph,
    warm_run,
)
from metrics_tpu_torch.utilities.checks import tracing
from metrics_tpu_torch.utilities.data import bucket_pow2

__all__ = [
    "HashRing",
    "ShardedMetricsService",
    "ShardDeadError",
    "FleetDeadError",
    "StaleEpochError",
]

# re-export: callers catching zombie writes shouldn't need to know the
# fence lives in the journal layer
StaleEpochError = wal.StaleEpochError


class ShardDeadError(RuntimeError):
    """The shard owning this session is dead and automatic failover is
    disabled (``auto_failover=False``); call :meth:`fail_over` first."""


class FleetDeadError(ShardDeadError):
    """Every shard is dead (or retired): there is no live peer left to
    recover a partition on. Terminal for the fleet — the message names
    the dead shards so the operator knows what to restart. Subclasses
    :class:`ShardDeadError` so existing handlers still catch it."""


def _point(key: str) -> int:
    """Stable 64-bit ring coordinate (md5 — deterministic across
    processes and PYTHONHASHSEED, well-mixed for small vnode counts)."""
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring over shard ids with virtual nodes.

    Routing is a pure function of the session name: hash the name, walk
    clockwise to the next vnode, return its shard. Removing a shard
    remaps ONLY that shard's arc (its sessions land on the clockwise
    survivors) — the property failover relies on. Note the fabric keeps
    dead partitions addressable by re-hosting them instead of shrinking
    the ring, so session→shard stays stable across failovers; the ring's
    clockwise walk also picks the designated recovery peer.
    """

    def __init__(self, shard_ids: List[int], vnodes: int = 64) -> None:
        if not shard_ids:
            raise ValueError("HashRing needs at least one shard")
        self.vnodes = int(vnodes)
        self.shard_ids = sorted(int(s) for s in shard_ids)
        points: List[Tuple[int, int]] = []
        for sid in self.shard_ids:
            for v in range(self.vnodes):
                points.append((_point(f"shard-{sid}:vnode-{v}"), sid))
        points.sort()
        self._hashes = [h for h, _ in points]
        self._owners = [s for _, s in points]

    def owner(self, session: str) -> int:
        """The shard id owning ``session`` (clockwise successor vnode)."""
        h = _point(str(session))
        i = bisect_right(self._hashes, h) % len(self._hashes)
        return self._owners[i]

    def successor(self, shard_id: int, alive: Optional[List[int]] = None) -> int:
        """Next shard clockwise from ``shard_id``'s first vnode — the
        designated recovery peer. With ``alive`` given, dead candidates
        are skipped (cascading failover)."""
        candidates = set(self.shard_ids if alive is None else alive)
        candidates.discard(shard_id)
        if not candidates:
            dead = sorted(set(self.shard_ids) - candidates)
            raise FleetDeadError(
                f"fleet dead: no live peer to recover shard {shard_id} "
                f"(dead shards: {dead})"
            )
        start = _point(f"shard-{shard_id}:vnode-0")
        i = bisect_right(self._hashes, start)
        for step in range(len(self._hashes)):
            sid = self._owners[(i + step) % len(self._hashes)]
            if sid in candidates:
                return sid
        return sorted(candidates)[0]

    def spread(self, sessions: List[str]) -> Dict[int, int]:
        """Session count per shard (balance diagnostics / tests)."""
        counts: Dict[int, int] = {sid: 0 for sid in self.shard_ids}
        for name in sessions:
            counts[self.owner(name)] += 1
        return counts

    def arc_losers(self, target: "HashRing") -> set:
        """Shard ids owning at least one arc of THIS ring whose owner
        differs under ``target`` — the set a planned hand-off must fence:
        any session (open now or submitted mid-move) hashing into a moved
        arc currently routes to one of these shards. Ownership is
        piecewise-constant between ring points, so probing just past
        every boundary of either ring covers each (old, new) ownership
        interval exactly once."""
        losers: set = set()
        for h in set(self._hashes) | set(target._hashes):
            i = bisect_right(self._hashes, h) % len(self._hashes)
            j = bisect_right(target._hashes, h) % len(target._hashes)
            if self._owners[i] != target._owners[j]:
                losers.add(self._owners[i])
        return losers


def _nbytes(x: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _flatten(x)[0] if isinstance(t, Tensor))


def _split_args(n: int, tensors: List[Tensor]) -> Tuple:
    """A fleet program's arguments after the buffers: the first ``n`` tensors
    (the shards' row indices) as one tuple, then the rest."""
    return (tuple(tensors[:n]),) + tuple(tensors[n:])


class _Shard:
    """One partition: durable directories + the service currently hosting
    it. The partition id is permanent; the hosting service is replaced on
    failover (a fresh ``MetricsService`` at a higher epoch)."""

    __slots__ = ("shard_id", "journal_dir", "checkpoint_dir", "service",
                 "alive", "epoch", "host", "failovers", "rid_offset",
                 "rid_stride", "retired", "suspect", "down_cause")

    def __init__(
        self,
        shard_id: int,
        service: MetricsService,
        journal_dir: Optional[str],
        checkpoint_dir: Optional[str],
        epoch: int,
    ) -> None:
        self.shard_id = shard_id
        self.service = service
        self.journal_dir = journal_dir
        self.checkpoint_dir = checkpoint_dir
        self.alive = True
        self.epoch = epoch
        # which partition's host serves this one (itself until failover)
        self.host = shard_id
        self.failovers = 0
        # rid lattice currently assigned to this partition (rebased on
        # membership changes so rids stay globally unique)
        self.rid_offset = service._rid
        self.rid_stride = service._rid_stride
        # membership / degradation flags
        self.retired = False        # removed via remove_shard(); permanent
        self.suspect = False        # flagged by the suspicion monitor
        self.down_cause: Optional[str] = None  # why it last went down


class ShardedMetricsService:
    """N-shard serving fabric over one template metric.

    Args:
        template: the metric template (deep-copied per shard — shards
            share nothing mutable).
        num_shards: partition count. Session→shard is consistent hashing
            of the session id (:class:`HashRing`), so the mapping is
            stable across restarts and processes.
        data_dir: root for per-shard durable state — shard ``k`` journals
            under ``<data_dir>/shard-<k>/wal`` and checkpoints under
            ``<data_dir>/shard-<k>/ckpt``. ``None`` disables durability
            (pure in-memory shards; failover is impossible).
        vnodes: virtual nodes per shard on the ring.
        auto_failover: route-time behavior when the owning shard is dead
            — ``True`` (default) runs :meth:`fail_over` inline and serves
            the request on the recovered host; ``False`` raises
            :class:`ShardDeadError`.
        standby: hot-standby replication. ``True`` provisions a warm
            :class:`~metrics_tpu_torch.wal.StandbyReplica` per shard (hosted at
            its ring successor) on the first :meth:`replicate` call;
            failover then promotes the standby and replays only the
            unshipped journal tail — O(replication lag) instead of
            O(journal).
        suspect_p99_multiple / suspect_min_requests: gray-failure
            suspicion threshold — :meth:`suspicion_sweep` quarantines a
            shard whose served p99 exceeds ``suspect_p99_multiple`` times
            its peers' median, once it has served at least
            ``suspect_min_requests`` requests (below that the sketch is
            noise).
        checkpoint_every / max_inflight / max_queue / admission /
            admission_timeout_s / request_deadline_s / flush_interval_s /
            coalesce:
            passed through to every shard's :class:`MetricsService`
            (queues and admission are strictly per-shard — one hot shard
            sheds without touching its neighbors).

    The ``shard-death`` fault class hooks the routing seam: while
    ``faults.inject("shard-death", shard=k)`` is active, the next route
    or probe touching shard ``k`` marks it dead, exactly as a missed
    heartbeat would.
    """

    def __init__(
        self,
        template: Any,
        num_shards: int = 4,
        *,
        data_dir: Optional[str] = None,
        vnodes: int = 64,
        auto_failover: bool = True,
        standby: bool = False,
        replication_precision: Optional[str] = None,
        suspect_p99_multiple: float = 4.0,
        suspect_min_requests: int = 32,
        coalesce: bool = True,
        checkpoint_every: int = 0,
        max_inflight: int = 2,
        max_queue: Optional[int] = None,
        admission: str = "block",
        admission_timeout_s: Optional[float] = None,
        request_deadline_s: Optional[float] = None,
        flush_interval_s: Optional[float] = None,
    ) -> None:
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = int(num_shards)
        self.data_dir = data_dir
        self.auto_failover = bool(auto_failover)
        self.label = f"ShardedMetricsService[{type(template).__name__}]"
        self.ring = HashRing(list(range(self.num_shards)), vnodes=vnodes)
        self._template = template
        self._service_kwargs: Dict[str, Any] = {
            "coalesce": coalesce,
            "checkpoint_every": checkpoint_every,
            "max_inflight": max_inflight,
            "max_queue": max_queue,
            "admission": admission,
            "admission_timeout_s": admission_timeout_s,
            "request_deadline_s": request_deadline_s,
            "flush_interval_s": flush_interval_s,
        }
        # authoritative per-tenant overrides: re-applied to the recovery
        # service after failover (overrides are routing metadata, not
        # journaled state)
        self._tenant_cfg: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self.stats: Dict[str, int] = {"failovers": 0, "dead_routes": 0,
                                      "handoffs": 0, "moved_sessions": 0,
                                      "fleet_reads": 0,
                                      "fleet_read_collectives": 0}
        self.failover_events: List[Dict[str, Any]] = []

        # hot-standby replication (see module docstring)
        self.standby = bool(standby)
        if replication_precision not in (None, "int8"):
            raise ValueError(
                f"replication_precision must be None or 'int8', got "
                f"{replication_precision!r}"
            )
        # opt-in quantized replication wire: ship batches and bulk
        # re-seeds cross as crc-guarded int8 frames (metrics_tpu_torch.wal
        # encode_ship_frame / encode_seed_frame) — float leaves lossy
        # within the documented codec bound, int/bool/opted-out leaves
        # exact; anti_entropy() switches to the tolerance-aware comparand
        self.replication_precision = replication_precision
        self._standbys: Dict[int, wal.StandbyReplica] = {}
        # gray-failure suspicion thresholds
        self.suspect_p99_multiple = float(suspect_p99_multiple)
        self.suspect_min_requests = int(suspect_min_requests)
        # elastic membership: admission fence (shard ids currently mid
        # hand-off — routes to them park until the swap completes) and the
        # ring the next rebalance() converges to
        self._fenced: set = set()
        self._fence_cond = threading.Condition()
        self._target_ring: Optional[HashRing] = None
        # final SLO snapshots of retired shards (loadgen's exactly-once
        # ledger still needs their served counts after remove_shard)
        self._retired_slo: Dict[int, Any] = {}
        # bounded pool for fleet-wide reads (created lazily)
        self._pool: Optional[ThreadPoolExecutor] = None
        # packed fleet-read programs, keyed (kind, n shards, session bucket, the leaves' signature, the indices'
        # signature, wire signature, the shards' buffers); a program's ``inputs`` are the index buffers its graph
        # reads. Only the programs of the shards' current leaves are kept (``_run_fleet``)
        self._fleet_programs: Dict[Tuple, _StackedProgram] = {}
        self._graph_pool: Any = None
        self._side_stream: Any = None
        # per-kind compile attribution for fleet compile spans
        self._fleet_seen: Dict[str, int] = {}

        self._shards: List[_Shard] = []
        for k in range(self.num_shards):
            journal_dir, checkpoint_dir = self.shard_dirs(k)
            epoch = (wal.read_epoch(journal_dir) or 0) + 1 if journal_dir else 0
            service = self._build_service(k, epoch)
            self._shards.append(_Shard(k, service, journal_dir, checkpoint_dir, epoch))

    # ---------------------------------------------------------------- layout
    def shard_dirs(self, shard_id: int) -> Tuple[Optional[str], Optional[str]]:
        """(journal_dir, checkpoint_dir) for one partition — the durable
        unit a peer replays on failover. ``(None, None)`` without a
        ``data_dir``."""
        if self.data_dir is None:
            return None, None
        root = os.path.join(self.data_dir, f"shard-{shard_id:02d}")
        return os.path.join(root, "wal"), os.path.join(root, "ckpt")

    def _build_service(
        self,
        shard_id: int,
        epoch: int,
        *,
        rid_offset: Optional[int] = None,
        rid_stride: Optional[int] = None,
        durable: bool = True,
    ) -> MetricsService:
        journal_dir, checkpoint_dir = self.shard_dirs(shard_id)
        kwargs = dict(self._service_kwargs)
        if not durable:
            # warm standby replica: no journal/checkpoint of its own (it
            # attaches the primary's on promotion), no background flusher,
            # no admission limit — applies arrive pre-admitted via
            # apply_records()
            journal_dir = checkpoint_dir = None
            kwargs.update(flush_interval_s=None, checkpoint_every=0,
                          max_queue=None)
        return MetricsService(
            copy.deepcopy(self._template),
            journal_dir=journal_dir,
            checkpoint_dir=checkpoint_dir,
            shard_id=shard_id,
            rid_offset=shard_id if rid_offset is None else int(rid_offset),
            rid_stride=self.num_shards if rid_stride is None else int(rid_stride),
            epoch=epoch,
            **kwargs,
        )

    # --------------------------------------------------------------- routing
    def shard_for(self, name: str) -> int:
        """The partition id owning session ``name`` (pure hash; no
        cross-shard reads)."""
        return self.ring.owner(name)

    # fault class -> failover cause recorded when it fires at the routing
    # seam. A partition is not a crash: the old host keeps running (the
    # returned zombie service), and only the epoch fence decides which
    # side's writes survive.
    _ROUTE_FAULTS = (("shard-death", "killed"), ("network-partition", "partition"))

    def _probe_death(self, shard: _Shard) -> None:
        """Routing-seam hook for the ``shard-death`` and
        ``network-partition`` fault classes: an active spec targeting this
        shard (param ``shard``, default = any) marks it down exactly as a
        missed liveness probe would, tagged with the matching cause."""
        if not shard.alive or shard.retired:
            return
        for fault, cause in self._ROUTE_FAULTS:
            params = faults.fault_params(fault)
            target = params.get("shard")
            if target is not None and int(target) != shard.shard_id:
                continue
            if faults.should_fire(fault):
                self.kill_shard(shard.shard_id, cause=cause)
                return

    def _route(self, name: str) -> _Shard:
        while True:
            shard = self._shards[self.shard_for(name)]
            # membership of the fence set is only meaningful under the
            # fence condition's lock — an unlocked peek could slip past a
            # fence mid-install and land a submit on a draining source
            with self._fence_cond:
                if shard.shard_id in self._fenced:
                    # mid hand-off: park until the ring swap, then
                    # re-route — ownership of this arc may have moved
                    while shard.shard_id in self._fenced:
                        self._fence_cond.wait(timeout=5.0)
                    continue
            self._probe_death(shard)
            if not shard.alive:
                self.stats["dead_routes"] += 1
                if not self.auto_failover:
                    raise ShardDeadError(
                        f"shard {shard.shard_id} (owner of session {name!r}) is "
                        "dead; call fail_over() to recover it on a peer"
                    )
                self.fail_over(shard.shard_id)
            return shard

    # ---------------------------------------------------------------- intake
    def submit(
        self, name: str, *args: Any, return_value: bool = False, **kwargs: Any
    ) -> Optional[ValueTicket]:
        """Route one update to the owning shard's queue. Strictly
        shard-local past the hash: the owning service journals, admits,
        and coalesces independently of every other shard."""
        return self._route(name).service.submit(
            name, *args, return_value=return_value, **kwargs
        )

    def update(self, name: str, *args: Any, **kwargs: Any) -> None:
        shard = self._route(name)
        shard.service.submit(name, *args, **kwargs)
        shard.service.flush()

    def forward(self, name: str, *args: Any, **kwargs: Any) -> Any:
        return self._route(name).service.forward(name, *args, **kwargs)

    def configure_session(self, name: str, **overrides: Any) -> None:
        """Per-tenant admission overrides, fabric edition: recorded
        authoritatively here, applied to the owning shard now, and
        re-applied to the recovery service after a failover."""
        self._tenant_cfg.setdefault(name, {}).update(overrides)
        self._route(name).service.configure_session(name, **overrides)

    def open_session(self, name: str) -> int:
        return self._route(name).service.open_session(name)

    def close_session(self, name: str) -> None:
        self._route(name).service.close_session(name)

    def reset_session(self, name: str) -> None:
        self._route(name).service.reset_session(name)

    # ----------------------------------------------------------------- fleet
    def _live_shards(self) -> List[_Shard]:
        return [s for s in self._shards if s.alive and not s.retired]

    def _serving_shards(self) -> List[_Shard]:
        """Every non-retired shard, healed: dead partitions are failed
        over first so a fleet-wide read never silently drops a partition.
        With ``auto_failover=False`` a dead shard raises instead — the
        caller must :meth:`fail_over` (or :meth:`probe`) explicitly."""
        serving = [s for s in self._shards if not s.retired]
        for shard in serving:
            self._probe_death(shard)
            if not shard.alive:
                if not self.auto_failover:
                    raise ShardDeadError(
                        f"shard {shard.shard_id} is dead; fail_over() it before "
                        "fleet-wide reads (its partition would be missing)"
                    )
                self.fail_over(shard.shard_id)
        return serving

    def _fan_out(self, fn, shards: List[_Shard]) -> List[Any]:
        """Map ``fn`` over shards on a bounded thread pool — fleet-wide
        reads pay max(shard) latency instead of sum(shard). Shard state is
        disjoint (per-shard flush locks guard each service), so the only
        ordering requirement is the healed shard list computed first. One
        shard degenerates to a plain call; the pool is created lazily and
        bounded at 8 so a wide fleet cannot fork-bomb the host. Host-side
        snapshot aggregation (and the packed read's degrade path) ride
        this pool; value reads themselves go through the packed program
        (:meth:`compute_all` / :meth:`rollup`) — one graph replay on the
        card for the whole fleet."""
        shards = list(shards)
        if len(shards) <= 1:
            return [fn(s) for s in shards]
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=min(8, len(shards)),
                thread_name_prefix=f"{self.label}-read",
            )
        return list(self._pool.map(fn, shards))

    def flush(self) -> int:
        """Flush every live shard; returns total requests served. One
        coalesced launch wave per shard per signature — shards never
        share a launch (the per-shard structural pin)."""
        return sum(s.service.flush() for s in self._live_shards())

    def drain(self) -> None:
        for s in self._live_shards():
            s.service.drain()

    def compute(self, name: str) -> Any:
        return self._route(name).service.compute(name)

    # ------------------------------------------------------- time travel
    def compute_at(self, t: float, name: Optional[str] = None) -> Any:
        """Fleet point-in-time read: each shard materializes its own
        partition as of wall-clock ``t`` from its checkpoint ladder +
        fenced journal replay (:meth:`MetricsService.compute_at`) — served
        through the fabric like any read (dead shards heal first, the
        union over disjoint partitions is exact, ``read:time-travel``
        spans per shard). With ``name`` the read routes to the owning
        shard alone."""
        if name is not None:
            return self._route(name).service.compute_at(t, name)
        out: Dict[str, Any] = {}
        for part in self._fan_out(
            lambda s: s.service.compute_at(t), self._serving_shards()
        ):
            out.update(part)
        return out

    def compute_range(self, t1: float, t2: float, name: Optional[str] = None) -> Any:
        """Fleet range read over journal ``ts`` in ``(t1, t2]`` — the
        per-shard :meth:`MetricsService.compute_range` fanned out on the
        bounded read pool, union-merged (partitions are disjoint)."""
        if name is not None:
            return self._route(name).service.compute_range(t1, t2, name)
        out: Dict[str, Any] = {}
        for part in self._fan_out(
            lambda s: s.service.compute_range(t1, t2), self._serving_shards()
        ):
            out.update(part)
        return out

    def scrub(self, *, quarantine: bool = True) -> Dict[int, Dict[str, Any]]:
        """Walk every serving shard's checkpoint ladder
        (:meth:`MetricsService.scrub`): verify, quarantine (never delete)
        corrupt rungs, re-pin journal floors. Returns per-shard reports
        keyed by shard id."""
        shards = self._serving_shards()
        reports = self._fan_out(
            lambda s: s.service.scrub(quarantine=quarantine), shards
        )
        return {s.shard_id: r for s, r in zip(shards, reports)}

    def _drop_fleet_programs(self) -> None:
        """A membership, failover or re-seed change moves shards' rows: the
        fleet graphs read the buffers they were captured on, so they go."""
        self._fleet_programs.clear()

    def _run_fleet(self, kind: str, n: int, m: int, builder: Any, shard_leaves: Tuple, host_args: List[np.ndarray],
                   wire_sig: Tuple = ()) -> Tuple[Any, Optional[cost_model.CostEntry]]:
        """Run the packed program of one fleet-read signature on
        ``shard_leaves`` (the shards' state buffers) and ``host_args`` (the
        shards' row indices, then the roll-up's mask): ``(its outputs, its
        cost entry)``. Built once per (kind, shard count, session bucket,
        input signature, wire signature), and on the card per set of state
        buffers: the first call runs the body on a side stream (this serves
        the read) and captures it into one CUDA graph; a later call copies
        its indices into the graph's buffers and replays it. The build is one
        ``compile`` span of kind ``fleet-<kind>`` with the program's cost
        attributes. A build drops the programs of other leaves (a capacity
        doubling reallocates them): those can never run again, and on the
        card each holds its graph's memory."""
        flat_leaves = [x for leaves in shard_leaves for x in leaves]
        dev = flat_leaves[0].device
        on_card = dev.type == "cuda"
        leaves = (tuple((tuple(x.shape), str(x.dtype)) for x in flat_leaves),
                  tuple(x.data_ptr() for x in flat_leaves) if on_card else ())
        key = (kind, n, m, leaves[0], tuple((tuple(a.shape), str(a.dtype)) for a in host_args), wire_sig, leaves[1])
        program = self._fleet_programs.get(key)
        if program is not None:
            if not on_card:
                with tracing():
                    return program.body(shard_leaves, *_split_args(n, [torch.from_numpy(a) for a in host_args])), \
                        program.cost
            for buf, a in zip(program.inputs, host_args):
                buf.copy_(torch.from_numpy(a).pin_memory(), non_blocking=True)
            program.graph.replay()
            registry.note_replay(program.launched)
            return copy_tensors(program.values), program.cost
        for old in [k for k in self._fleet_programs if (k[3], k[6]) != leaves]:
            del self._fleet_programs[old]
        t0 = time.perf_counter()
        program = _StackedProgram(builder())
        program.inputs = [torch.from_numpy(a).to(dev) for a in host_args]
        args = _split_args(n, program.inputs)
        if not on_card:
            with tracing():
                out = program.body(shard_leaves, *args)
        else:
            if self._side_stream is None:
                self._side_stream = torch.cuda.Stream(dev)
                self._graph_pool = torch.cuda.graph_pool_handle()
            out = warm_run(self._side_stream, lambda: program.body(shard_leaves, *args))
            allocated = torch.cuda.memory_stats(dev).get("allocated_bytes.all.current", 0)
            program.graph, program.values, program.launched = capture_graph(
                lambda: program.body(shard_leaves, *args), self._graph_pool)
            program.peak_temp_bytes = max(
                0, torch.cuda.memory_stats(dev).get("allocated_bytes.all.current", 0) - allocated)
        # the cost entry's terms: the rows gathered and the indices read; the values written
        row_bytes = sum(x[0].numel() * x.element_size() for x in flat_leaves)
        program.arg_bytes = m * row_bytes + sum(a.nbytes for a in host_args)
        program.out_bytes = _nbytes(out)
        program.cost = cost_model.record(self.label, f"fleet-{kind}", key, program)
        cause = "first-compile" if not self._fleet_seen.get(kind) else "new-signature"
        self._fleet_seen[kind] = self._fleet_seen.get(kind, 0) + 1
        telemetry.emit(
            "compile", self.label, f"fleet-{kind}", t0=t0, stream="serve",
            cause=cause, shards=n, session_bucket=m,
            **cost_model.compile_attrs(program.cost),
        )
        self._fleet_programs[key] = program
        return out, program.cost

    def compute_all(self) -> Dict[str, Any]:
        """Every open session fleet-wide (partitions are disjoint, so the
        union is exact). Dead shards are failed over first — a fleet read
        never silently omits a partition. Memo-clean sessions are served
        host-side from each shard's read memo; the DIRTY rows of every
        shard ride ONE packed-gather program (`sync_engine.build_fleet_read`)
        — one graph replay on the card and exactly one packed gather per
        fleet read, instead of N per-shard reads. Falls back to the
        bounded-pool per-shard fan-out (a ``fleet-read`` degrade) where the
        program fails, e.g. a value-dependent compute."""
        shards = self._serving_shards()
        self._fan_out(lambda s: s.service.flush(), shards)
        self.stats["fleet_reads"] += 1
        with contextlib.ExitStack() as held:
            # the shards' flush locks, in shard order: no flush writes a buffer the read gathers from
            for s in shards:
                held.enter_context(s.service._flush_lock)
            out = self._compute_all_locked(shards)
        if out is not None:
            return out
        out = {}
        for part in self._fan_out(lambda s: s.service.compute_all(), shards):
            out.update(part)
        return out

    def _compute_all_locked(self, shards: List[_Shard]) -> Optional[Dict[str, Any]]:
        """:meth:`compute_all` under the shards' flush locks; ``None`` where
        the packed program failed (a ``fleet-read`` degrade), and the caller
        fans the read out per shard instead."""
        t0 = telemetry.clock()
        plans = []  # (shard, names_sorted, memoized, dirty)
        for s in shards:
            names_sorted, memoized, dirty = s.service._read_plan()
            if memoized:
                s.service._check_read_epoch()
            s.service.stats["read_memo_hits"] += len(memoized)
            s.service.stats["read_memo_misses"] += len(dirty)
            plans.append((s, names_sorted, memoized, dirty))
        out: Dict[str, Any] = {}
        for _s, _names, memoized, _dirty in plans:
            out.update(memoized)
        dirty_plans = [(s, dirty) for s, _n, _m, dirty in plans if dirty]
        n_memo = len(out)
        if not dirty_plans:
            telemetry.emit(
                "read", self.label, "fleet", t0=t0, stream="serve",
                shards=len(shards), dirty=0, memoized=n_memo, collectives=0,
            )
            return out
        try:
            n = len(dirty_plans)
            m = bucket_pow2(
                max(len(dirty) for _s, dirty in dirty_plans),
                minimum=_MIN_SESSION_BUCKET,
            )
            template = dirty_plans[0][0].service.template
            leaf_names = dirty_plans[0][0].service._names
            shard_leaves = []
            shard_idx = []
            for s, dirty in dirty_plans:
                svc = s.service
                idx = np.full((m,), svc._capacity, dtype=np.int64)  # pad lanes: the scratch row
                for i, (_name, row, _ver) in enumerate(dirty):
                    idx[i] = row
                shard_leaves.append(tuple(svc._phys[k] for k in svc._names))
                shard_idx.append(idx)
            wire_specs = sync_engine._leaf_wire_specs(template, leaf_names, m=m)
            c0 = telemetry.clock()
            vals, cost_entry = self._run_fleet(
                "read", n, m,
                lambda: sync_engine.build_fleet_read(template, leaf_names, n, m),
                tuple(shard_leaves), shard_idx,
                wire_sig=sync_engine.fleet_wire_sig(wire_specs),
            )
            c_dur = None if c0 is None else (time.perf_counter() - c0) * 1e6
            self.stats["fleet_read_collectives"] += 1
            logical_nbytes = sum(spec[3] * n * m for spec in wire_specs)
            nbytes = sync_engine.fleet_wire_nbytes(wire_specs, n, m)
            telemetry.emit(
                "collective", self.label, "packed-read", t0=c0, dur_us=c_dur,
                nbytes=nbytes, logical_nbytes=logical_nbytes,
                quantized=any(spec[4] is not None for spec in wire_specs),
                nleaves=len(leaf_names), shards=n,
                **(cost_model.launch_attrs(cost_entry, c_dur)
                   if telemetry.subscribed() else {}),
            )
            n_dirty = 0
            for si, (s, dirty) in enumerate(dirty_plans):
                svc = s.service
                chaos = faults.any_active()
                for i, (name, _row, ver) in enumerate(dirty):
                    val = _lane_value(vals, si * m + i)
                    out[name] = val
                    if not chaos:
                        svc._memo[name] = (ver, svc.epoch, val)
                n_dirty += len(dirty)
            telemetry.emit(
                "read", self.label, "fleet", t0=t0, stream="serve",
                shards=len(shards), dirty=n_dirty, memoized=n_memo,
                collectives=1,
            )
            return out
        except Exception as err:  # noqa: BLE001 - e.g. value-dependent compute
            resilience.record_degrade(self.label, "fleet-read", err)
            self._drop_fleet_programs()
            return None

    def rollup(self, names: Optional[List[str]] = None) -> Any:
        """The fleet-wide merged value — every (or just the named) open
        session's state merged via the template's ``pure_merge`` algebra,
        then computed ONCE: cross-shard aggregation (fleet-wide macro
        averages, tenant rollups spanning shards) as one program with
        exactly one packed gather (`sync_engine.build_fleet_rollup`).
        Padded/absent lanes contribute exactly nothing (the windows' fold,
        :func:`metrics_tpu_torch.streaming.window.fold_rows`), so the result
        is bit-identical to a host-side left fold over the same rows in
        packed order."""
        shards = self._serving_shards()
        self._fan_out(lambda s: s.service.flush(), shards)
        self.stats["fleet_reads"] += 1
        with contextlib.ExitStack() as held:
            for s in shards:
                held.enter_context(s.service._flush_lock)
            return self._rollup_locked(shards, names)

    def _rollup_locked(self, shards: List[_Shard], names: Optional[List[str]]) -> Any:
        t0 = telemetry.clock()
        want = None if names is None else set(names)
        per_shard_rows: List[List[int]] = []
        for s in shards:
            svc = s.service
            per_shard_rows.append([
                svc._rows[n] for n in sorted(svc._rows)
                if want is None or n in want
            ])
        n = len(shards)
        m = bucket_pow2(
            max((len(r) for r in per_shard_rows), default=1),
            minimum=_MIN_SESSION_BUCKET,
        )
        # the template of a shard that holds a rolled-up row: a template's configuration may come from its
        # first input (Accuracy's mode), so a shard that served nothing cannot compute (the JAX package takes
        # shards[0] and raises there)
        source = next((s for s, rows in zip(shards, per_shard_rows) if rows), shards[0])
        template = source.service.template
        leaf_names = source.service._names
        shard_leaves = []
        shard_idx = []
        valid = np.zeros((n * m,), dtype=bool)
        for si, (s, rows) in enumerate(zip(shards, per_shard_rows)):
            svc = s.service
            idx = np.full((m,), svc._capacity, dtype=np.int64)
            idx[: len(rows)] = rows
            valid[si * m : si * m + len(rows)] = True
            shard_leaves.append(tuple(svc._phys[k] for k in svc._names))
            shard_idx.append(idx)
        wire_specs = sync_engine._leaf_wire_specs(template, leaf_names, m=m)
        r0 = telemetry.clock()
        val, cost_entry = self._run_fleet(
            "rollup", n, m,
            lambda: sync_engine.build_fleet_rollup(template, leaf_names, n, m),
            tuple(shard_leaves), shard_idx + [valid],
            wire_sig=sync_engine.fleet_wire_sig(wire_specs),
        )
        r_dur = None if r0 is None else (time.perf_counter() - r0) * 1e6
        self.stats["fleet_read_collectives"] += 1
        telemetry.emit(
            "read", self.label, "rollup", t0=t0, stream="serve",
            shards=n, sessions=int(valid.sum()), collectives=1,
            nbytes=sync_engine.fleet_wire_nbytes(wire_specs, n, m),
            logical_nbytes=sum(spec[3] * n * m for spec in wire_specs),
            **(cost_model.launch_attrs(cost_entry, r_dur)
               if telemetry.subscribed() else {}),
        )
        return val

    def checkpoint(self) -> List[str]:
        return [s.service.checkpoint() for s in self._serving_shards()]

    def recover(self) -> int:
        """First-boot / restart recovery: every shard restores its own
        checkpoint + journal tail (``missing_ok`` — fresh directories are
        zero-config). Returns how many shards had a checkpoint."""
        return sum(1 for s in self._live_shards() if s.service.recover())

    def shutdown(self) -> None:
        for s in self._live_shards():
            s.service.shutdown()
        for standby in self._standbys.values():
            standby.service.shutdown()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    # -------------------------------------------------------------- liveness
    def heartbeat(self) -> Dict[int, bool]:
        """One liveness sample per shard. A live shard answers its
        ``health()`` probe; a dead one (killed, or with an active
        ``shard-death`` fault targeting it) reports ``False``."""
        beats: Dict[int, bool] = {}
        for shard in self._shards:
            if shard.retired:
                continue
            self._probe_death(shard)
            if shard.alive:
                try:
                    shard.service.health()
                except Exception:  # noqa: BLE001 - a dead host answers nothing
                    shard.alive = False
                    shard.down_cause = "heartbeat"
            beats[shard.shard_id] = shard.alive
        return beats

    def probe(self) -> List[int]:
        """Heartbeat sweep + failover of every dead shard. Returns the
        shard ids failed over (the caller-driven liveness loop)."""
        failed = [sid for sid, ok in self.heartbeat().items() if not ok]
        for sid in failed:
            self.fail_over(sid)
        return failed

    def kill_shard(self, shard_id: int, cause: str = "killed") -> MetricsService:
        """Mark one shard dead (the in-process twin of SIGKILLing its
        host). The old service object is returned — it plays the zombie
        in fencing tests: any journaled write through it after the peer
        fences raises :class:`StaleEpochError`. No flush, no checkpoint,
        no goodbye — exactly what SIGKILL leaves behind. ``cause`` is
        recorded on the eventual failover event (``killed`` by default;
        ``partition`` when the host is alive but unreachable)."""
        shard = self._shards[shard_id]
        shard.alive = False
        shard.down_cause = cause
        return shard.service

    def fail_over(self, shard_id: int, cause: Optional[str] = None) -> float:
        """Recover a dead shard's partition on its designated peer.

        Fence-then-replay: bump the partition's journal epoch
        (:func:`metrics_tpu_torch.wal.fence_epoch`) so the zombie is locked out
        BEFORE any state moves. With a warm standby for this partition,
        promotion attaches the durable directories to the replica and
        replays only the journal tail above its applied cursor —
        O(replication lag). Without one, a fresh service over the dead
        shard's directories ``recover()``\\ s the checkpoint + exactly-once
        journal tail (the full-replay path). Per-tenant overrides re-apply
        from the fabric's authoritative copy. ``cause`` lands on the
        failover event (defaults to the recorded down cause). Returns the
        failover wall time in ms (fence + recover + first health probe),
        which the ``failover`` telemetry span carries."""
        shard = self._shards[shard_id]
        with self._lock:
            if shard.alive and shard.failovers and shard.host != shard.shard_id:
                return 0.0  # another thread already recovered it
            if shard.journal_dir is None:
                raise ShardDeadError(
                    f"shard {shard_id} has no durable state (data_dir=None); "
                    "its sessions are lost — nothing to replay on a peer"
                )
            cause = cause or shard.down_cause or "killed"
            peer = self.ring.successor(
                shard_id, alive=[s.shard_id for s in self._live_shards()]
            )
            t0 = telemetry.clock()
            w0 = time.monotonic()
            new_epoch = max(shard.epoch, wal.read_epoch(shard.journal_dir)) + 1
            wal.fence_epoch(shard.journal_dir, new_epoch)
            standby = self._standbys.pop(shard_id, None)
            replayed: Optional[int] = None
            if standby is not None:
                # promote: the replica is already warm up to its applied
                # cursor — attach the partition's directories at the new
                # epoch and replay only the unshipped tail
                service = standby.service
                service.attach_durability(
                    shard.journal_dir, shard.checkpoint_dir, new_epoch
                )
                replayed = service._replay_journal(standby.applied_seq)
            else:
                service = self._build_service(
                    shard_id, new_epoch,
                    rid_offset=shard.rid_offset, rid_stride=shard.rid_stride,
                )
                service.recover()
            for name, cfg in self._tenant_cfg.items():
                if self.shard_for(name) == shard_id:
                    service.configure_session(name, **cfg)
            shard.service = service
            self._drop_fleet_programs()
            shard.epoch = new_epoch
            shard.alive = True
            shard.suspect = False
            shard.down_cause = None
            shard.host = peer
            shard.failovers += 1
            self.stats["failovers"] += 1
            ms = (time.monotonic() - w0) * 1e3
            event = {
                "shard": shard_id,
                "peer": peer,
                "epoch": new_epoch,
                "ms": round(ms, 3),
                "sessions": service.session_count,
                "cause": cause,
                "standby": standby is not None,
            }
            if replayed is not None:
                event["replayed"] = replayed
            self.failover_events.append(event)
            telemetry.emit(
                "failover", self.label, "shard-death", t0=t0, stream="serve",
                **event,
            )
            return ms

    # ------------------------------------------------------------ membership
    def _serving_ids(self) -> List[int]:
        return [s.shard_id for s in self._shards if not s.retired]

    def _fence(self, shard_ids: List[int]) -> None:
        """Admission fence: routes to these shards park until unfenced —
        no submit can land on a partition mid hand-off."""
        with self._fence_cond:
            self._fenced.update(shard_ids)

    def _unfence(self, shard_ids: List[int]) -> None:
        with self._fence_cond:
            self._fenced.difference_update(shard_ids)
            self._fence_cond.notify_all()

    def add_shard(self) -> int:
        """Provision one new, empty shard (scale-out). Returns the new
        shard id. Routing stays on the OLD ring until :meth:`rebalance`
        hands the moved arc over — the new shard serves nothing until
        then, so adding capacity is never observable mid-provision."""
        with self._lock:
            sid = len(self._shards)
            journal_dir, checkpoint_dir = self.shard_dirs(sid)
            epoch = (wal.read_epoch(journal_dir) or 0) + 1 if journal_dir else 0
            service = self._build_service(sid, epoch)
            self._shards.append(
                _Shard(sid, service, journal_dir, checkpoint_dir, epoch)
            )
            self._drop_fleet_programs()
            self.num_shards = len(self._serving_ids())
            self._target_ring = HashRing(
                self._serving_ids(), vnodes=self.ring.vnodes
            )
            # the fresh service was built on the default (shard-id,
            # old-stride) lattice, which can collide with an existing
            # shard's residue (e.g. 2 shards at stride 2, new shard 2 →
            # same lattice as shard 0). Rebase the fleet NOW — a submit
            # routed anywhere before rebalance() completes must never
            # mint a duplicate rid.
            self._rebase_rid_lattice()
            telemetry.emit(
                "membership", self.label, "add-shard", t0=telemetry.clock(),
                stream="serve", shard=sid, num_shards=self.num_shards,
            )
            return sid

    def remove_shard(self, shard_id: int) -> List[str]:
        """Retire one shard (scale-in): hand its entire partition to the
        ring survivors with a planned drain — zero kills, zero replay on
        the receivers — then drop it from the ring and shut it down. Its
        final SLO snapshot is archived so fleet accounting (the
        exactly-once ledger in loadgen) still sees its served counts.
        Returns the session names that moved."""
        shard = self._shards[shard_id]
        if shard.retired:
            raise ValueError(f"shard {shard_id} is already retired")
        survivors = [sid for sid in self._serving_ids() if sid != shard_id]
        if not survivors:
            raise FleetDeadError(
                f"cannot remove shard {shard_id}: it is the last live shard "
                "(the fleet would be dead)"
            )
        if not shard.alive:
            # recover first — planned removal moves state, never loses it
            self.fail_over(shard_id)
        with self._lock:
            self._target_ring = HashRing(survivors, vnodes=self.ring.vnodes)
        moved = self.rebalance()["moved"]
        with self._lock:
            self._retired_slo[shard_id] = shard.service.slo_snapshot()
            self._standbys.pop(shard_id, None)
            shard.service.shutdown()
            shard.retired = True
            shard.alive = False
            shard.down_cause = "planned"
            self._drop_fleet_programs()
            self.num_shards = len(survivors)
            self._rebase_rid_lattice()
            telemetry.emit(
                "membership", self.label, "remove-shard", t0=telemetry.clock(),
                stream="serve", shard=shard_id, num_shards=self.num_shards,
                moved=len(moved),
            )
        return moved

    def rebalance(self) -> Dict[str, Any]:
        """Converge session placement to the target ring set by
        :meth:`add_shard` / :meth:`remove_shard` — the planned hand-off.

        The sequence is **fence → drain → plan → transfer → swap**. The
        fence set comes from the RING DIFF (:meth:`HashRing.arc_losers`),
        not from open sessions: every shard losing any arc parks
        admissions — including one with no open session in the moved
        range — so a submit racing the swap can never open a fresh row on
        the old owner and strand it behind the new ring (zero lost
        submits). Per fenced source, ``drain()`` retires every admitted
        request into the stacked state, the source's journal epoch bumps
        (:meth:`MetricsService.advance_epoch` — a superseded writer of
        the moved range now raises :class:`StaleEpochError`), and only
        THEN is the move plan drawn — sessions opened between the target
        ring being set and the fence landing are included. Exactly the
        sessions whose target-ring owner changed transfer as portable
        state rows (:meth:`MetricsService.export_sessions` /
        ``import_sessions`` — bit-identical, no re-execution); the rid
        lattice rebases and the ring swaps before the fence lifts.
        Consistent hashing makes the plan minimal: ~1/N of the sessions,
        never a reshuffle. Both sides checkpoint (the moved rows live in
        no journal) and their standbys re-seed. Returns the move report
        (``moved`` names, per-pair events, wall ms)."""
        with self._lock:
            target = self._target_ring
            if target is None:
                return {"moved": [], "handoffs": 0, "ms": 0.0}
            srcs = sorted(
                sid for sid in self.ring.arc_losers(target)
                if not self._shards[sid].retired
            )
        # a dead source still owns durable rows: recover it first so the
        # hand-off transfers its state instead of abandoning it
        for sid in srcs:
            if not self._shards[sid].alive:
                self.fail_over(sid)
        t0 = telemetry.clock()
        w0 = time.monotonic()
        moved: List[str] = []
        touched: set = set()
        handoffs = 0
        self._fence(srcs)
        try:
            for src_id in srcs:
                shard = self._shards[src_id]
                h0 = time.monotonic()
                shard.service.drain()
                if shard.journal_dir is not None:
                    shard.epoch = shard.service.advance_epoch(
                        max(shard.epoch, wal.read_epoch(shard.journal_dir)) + 1
                    )
                # plan under the fence: exactly the open sessions whose
                # owner changes, with every pre-fence admission drained
                dests: Dict[int, List[str]] = {}
                for name in sorted(shard.service._rows):
                    dst = target.owner(name)
                    if dst != src_id:
                        dests.setdefault(dst, []).append(name)
                if dests:
                    handoffs += 1
                for dst_id in sorted(dests):
                    names = dests[dst_id]
                    dst = self._shards[dst_id]
                    dst.service.import_sessions(
                        shard.service.export_sessions(names)
                    )
                    for name in names:
                        cfg = self._tenant_cfg.get(name)
                        if cfg:
                            dst.service.configure_session(name, **cfg)
                    moved.extend(names)
                    touched.update((src_id, dst_id))
                    self.failover_events.append({
                        "shard": src_id,
                        "peer": dst_id,
                        "epoch": shard.epoch,
                        "ms": round((time.monotonic() - h0) * 1e3, 3),
                        "sessions": len(names),
                        "cause": "planned",
                        "standby": False,
                    })
                for dst_id in dests:
                    for name in dests[dst_id]:
                        shard.service.close_session(name)
            with self._lock:
                self.ring = target
                self._target_ring = None
                self._drop_fleet_programs()
                # rebase before the fence lifts: a submit routed the
                # instant admissions resume must already see a
                # collision-free lattice
                self._rebase_rid_lattice()
        finally:
            self._unfence(srcs)
        # moved rows exist in no journal: both sides checkpoint so a crash
        # after the swap recovers them, and their standbys re-seed (the
        # state transfer bypassed the shipped log)
        for sid in sorted(touched):
            svc = self._shards[sid].service
            if self._shards[sid].checkpoint_dir is not None:
                svc.checkpoint()
            standby = self._standbys.get(sid)
            if standby is not None:
                with svc._flush_lock:
                    standby.seed_from(svc, svc.replication_floor())
                if svc.journal is not None:
                    svc.journal.retain_seq = standby.cursor
        with self._lock:
            self.stats["handoffs"] += handoffs
            self.stats["moved_sessions"] += len(moved)
        ms = (time.monotonic() - w0) * 1e3
        telemetry.emit(
            "handoff", self.label, "planned", t0=t0, stream="serve",
            sources=handoffs, fenced=len(srcs), sessions=len(moved),
            ms=round(ms, 3),
        )
        return {"moved": moved, "handoffs": handoffs, "ms": ms}

    def _rebase_rid_lattice(self) -> None:
        """Re-base every live shard's request-id lattice to
        ``fleet_max_rid + position, stride = live shards`` — rids stay
        globally unique across any sequence of joins and leaves. Caller
        holds the fabric lock."""
        live = [s for s in self._shards if not s.retired]
        if not live:
            return
        stride = len(live)
        base = max(s.service._rid for s in live) + stride
        for pos, s in enumerate(sorted(live, key=lambda s: s.shard_id)):
            s.service.rebase_rids(base + pos, stride)
            s.rid_offset, s.rid_stride = base + pos, stride
            standby = self._standbys.get(s.shard_id)
            if standby is not None:
                standby.service.rebase_rids(base + pos, stride)

    # ----------------------------------------------------------- replication
    def replicate(self, shard_id: Optional[int] = None) -> Dict[int, int]:
        """Advance the warm standbys: ship each primary's journal tail
        (:meth:`~metrics_tpu_torch.wal.WriteAheadLog.stream_since` above the
        standby's cursor) plus the current replication floor. The first
        call per shard seeds its standby by bulk state transfer at the
        floor (a copy of the primary's rows). Returns
        applied-record counts per shard. Call it from the same periodic
        loop as :meth:`probe` — replication lag, and therefore failover
        cost, is bounded by how often this runs."""
        shards = (
            self._serving_shards() if shard_id is None
            else [self._shards[shard_id]]
        )
        out: Dict[int, int] = {}
        for shard in shards:
            if shard.retired or not shard.alive:
                continue
            if shard.service.journal is None:
                continue
            out[shard.shard_id] = self._ship(shard)
        return out

    def _ship(self, shard: _Shard) -> int:
        journal = shard.service.journal
        standby = self._standbys.get(shard.shard_id)
        if standby is None:
            standby = self._new_standby(shard)
            if standby is None:
                return 0
            self._standbys[shard.shard_id] = standby
            journal.retain_seq = standby.cursor
            return 0
        if journal.first_seq() > standby.cursor + 1:
            # a checkpoint truncated records the standby never streamed
            # (the retain floor was cleared or not yet pinned): streaming
            # would leap the gap and silently lose those records on
            # promotion — re-seed by bulk state transfer instead
            return self._reseed(shard, standby)
        # floor FIRST, then stream: everything at or below the floor is
        # durably on disk, so the shipped batch always covers it — the
        # standby never advances past a record it has not seen
        floor = shard.service.replication_floor()
        records = journal.stream_since(standby.cursor)
        if records and records[0].seq > standby.cursor + 1:
            # truncation raced the stream read past the gap check
            return self._reseed(shard, standby)
        # a mid-stream truncation can cut the batch short: never advance
        # the applied floor past what actually shipped (the next ship
        # detects the gap, if any, and re-seeds)
        floor = min(floor, records[-1].seq if records else standby.cursor)
        nbytes = logical_nbytes = 0
        if self.replication_precision is not None:
            # the batch crosses the shard boundary as a crc-guarded
            # quantized wire frame — float args int8, everything else
            # exact. A garbled frame (the quant-corruption fault, or
            # real bit damage) fails the crc and raises
            # StateCorruptionError before any state can diverge.
            frame = wal.encode_ship_frame(
                records, floor, precision=self.replication_precision
            )
            nbytes = len(frame)
            if telemetry.subscribed():
                logical_nbytes = len(wal.encode_ship_frame(records, floor))
            if faults.should_fire("quant-corruption"):
                frame = frame[: len(frame) // 2] + bytes(
                    [frame[len(frame) // 2] ^ 0xFF]
                ) + frame[len(frame) // 2 + 1 :]
            records, floor = wal.decode_ship_frame(frame)
            standby.lossy_budget += wal.frame_error_budget(frame)
        applied = standby.apply(records, floor)
        # hold truncation back to the ship cursor: the next checkpoint
        # fence must not delete records the standby has not streamed
        journal.retain_seq = standby.cursor
        telemetry.emit(
            "replicate", self.label, "ship", t0=telemetry.clock(),
            stream="serve", shard=shard.shard_id, records=len(records),
            applied=applied, floor=floor, nbytes=nbytes,
            logical_nbytes=logical_nbytes,
            quantized=self.replication_precision is not None,
        )
        return applied

    def _reseed(self, shard: _Shard, standby: wal.StandbyReplica) -> int:
        """Bulk repair after a replication gap (journal truncated past
        the ship cursor): pin the primary's floor under its flush lock,
        mirror its state, and rewind the cursor — the warm copy is
        bit-identical again and the next ship streams from the floor."""
        svc = shard.service
        with svc._flush_lock:
            floor = svc.replication_floor()
            standby.seed_from(svc, floor, precision=self.replication_precision)
        svc.journal.retain_seq = standby.cursor
        telemetry.emit(
            "replicate", self.label, "reseed-gap", t0=telemetry.clock(),
            stream="serve", shard=shard.shard_id, floor=floor,
        )
        return 0

    def _new_standby(self, shard: _Shard) -> Optional[wal.StandbyReplica]:
        live = [s.shard_id for s in self._live_shards()]
        if len(live) < 2:
            return None  # no peer to host a standby on
        host = self.ring.successor(shard.shard_id, alive=live)
        replica = self._build_service(
            shard.shard_id, epoch=0,
            rid_offset=shard.rid_offset, rid_stride=shard.rid_stride,
            durable=False,
        )
        standby = wal.StandbyReplica(replica, source_shard=shard.shard_id)
        with shard.service._flush_lock:
            # pin the floor: no flush may advance the state between the
            # floor read and the mirror, or the cursor would lie
            floor = shard.service.replication_floor()
            standby.seed_from(
                shard.service, floor, precision=self.replication_precision
            )
        standby.host = host
        return standby

    def _lossy_states_close(self, svc: MetricsService, standby: wal.StandbyReplica) -> bool:
        """Quantization-aware anti-entropy comparand. A standby fed
        int8-quantized wire frames can never be bit-identical on float
        leaves, so those compare within the standby's accumulated error
        allowance — ``standby.lossy_budget``, the exact sum of
        per-element ``scale / 2`` bounds over every quantized frame it
        ingested since its last seed (:func:`metrics_tpu_torch.wal.
        frame_error_budget`), not a guess from state magnitudes. Integer
        / bool / opted-out leaves must still match bit-for-bit, so real
        corruption on exact state is never excused by the float
        allowance."""
        sb = standby.service
        if sorted(svc._rows) != sorted(sb._rows):
            return False
        optout = getattr(svc.template, "_quantize", None) or {}
        tol = standby.lossy_budget * (1.0 + 1e-6) + 1e-9
        for name in sorted(svc._rows):
            rp, rs = svc._rows[name], sb._rows[name]
            for k in svc._names:
                a = np.asarray(svc._stacked[k][rp])
                b = np.asarray(sb._stacked[k][rs])
                lossy = a.dtype.kind == "f" and optout.get(k, True)
                if lossy:
                    if not np.allclose(a, b, rtol=0.0, atol=tol):
                        return False
                elif not np.array_equal(a, b):
                    return False
        return True

    def anti_entropy(self) -> List[int]:
        """Checksum every standby against its primary at a common
        replication floor (:meth:`MetricsService.state_digest` — sha1 of
        the stacked rows); a divergent standby is re-seeded by bulk state
        transfer. Returns the shard ids that diverged. Divergence should
        never happen through the shipping path — this is the backstop
        that turns a silent replica corruption into a bounded repair.
        Under ``replication_precision="int8"`` the digest comparison
        becomes tolerance-aware for lossy float leaves
        (:meth:`_lossy_states_close`) — the quantized wire's bounded
        error is expected, not divergence."""
        diverged: List[int] = []
        for shard in self._live_shards():
            standby = self._standbys.get(shard.shard_id)
            if standby is None or shard.service.journal is None:
                continue
            svc = shard.service
            with svc._flush_lock:
                floor = svc.replication_floor()
                if svc.journal.first_seq() > standby.cursor + 1:
                    # replication gap (truncated past the ship cursor):
                    # the warm copy cannot be caught up by streaming
                    ok = False
                else:
                    records = svc.journal.stream_since(standby.cursor)
                    standby.apply(
                        records,
                        min(floor, records[-1].seq if records else standby.cursor),
                    )
                    if self.replication_precision is not None:
                        ok = self._lossy_states_close(svc, standby)
                    else:
                        ok = svc.state_digest() == standby.digest()
                if not ok:
                    diverged.append(shard.shard_id)
                    standby.seed_from(
                        svc, floor, precision=self.replication_precision
                    )
                svc.journal.retain_seq = standby.cursor
            telemetry.emit(
                "anti-entropy", self.label, "scrub", t0=telemetry.clock(),
                stream="serve", shard=shard.shard_id, diverged=not ok,
            )
        return diverged

    # ------------------------------------------------------------- suspicion
    def suspicion_sweep(
        self,
        multiple: Optional[float] = None,
        min_requests: Optional[int] = None,
    ) -> List[int]:
        """Gray-failure containment: compare each shard's served p99
        (from its SLO sketches) against the median of its PEERS — the
        other measurable shards, its own sample excluded; any shard above
        ``multiple`` x that baseline (default ``suspect_p99_multiple``)
        is marked *suspect* and quarantined — drained (it is alive and
        correct, just slow: nothing is lost), final tail shipped to its
        standby, then fenced and failed over to the designated peer with
        cause ``suspect-slow``. Returns the quarantined shard ids. Shards
        under ``min_requests`` served are skipped (sketch noise), and a
        fleet of fewer than two measurable shards has no baseline to
        trust. Excluding the candidate's own sample keeps the threshold
        meaningful down to a 2-shard fleet: a self-inclusive median made
        ``slow > multiple * median`` unsatisfiable at n=2 for any
        ``multiple >= 2``."""
        multiple = (
            self.suspect_p99_multiple if multiple is None else float(multiple)
        )
        min_requests = (
            self.suspect_min_requests if min_requests is None
            else int(min_requests)
        )
        p99s: Dict[int, float] = {}
        for shard in self._live_shards():
            totals = shard.service.slo_snapshot()["totals"]
            if int(totals.get("served", 0)) < min_requests:
                continue
            p99 = float((totals.get("e2e_us") or {}).get("p99") or 0.0)
            if p99 > 0.0:
                p99s[shard.shard_id] = p99
        if len(p99s) < 2:
            return []
        suspects: List[int] = []
        baselines: Dict[int, float] = {}
        for sid in sorted(p99s):
            peers = [v for k, v in p99s.items() if k != sid]
            baseline = statistics.median(peers)
            if baseline > 0.0 and p99s[sid] > multiple * baseline:
                suspects.append(sid)
                baselines[sid] = baseline
        for sid in suspects:
            self._shards[sid].suspect = True
            telemetry.emit(
                "suspect", self.label, "gray-failure", t0=telemetry.clock(),
                stream="serve", shard=sid, p99_us=round(p99s[sid], 1),
                peer_median_us=round(baselines[sid], 1), multiple=multiple,
            )
            self.quarantine(sid)
        return suspects

    def quarantine(self, shard_id: int) -> float:
        """Route around a suspect-but-alive shard: drain it (planned —
        every admitted request retires into state first), ship the final
        journal tail to its standby, then fence and fail its partition
        over to the designated peer (cause ``suspect-slow``). The slow
        host's old service becomes the zombie — any later write through
        it raises :class:`StaleEpochError`."""
        shard = self._shards[shard_id]
        if shard.alive:
            try:
                shard.service.drain()
                if shard.shard_id in self._standbys:
                    self._ship(shard)
            except Exception:  # noqa: BLE001 — a truly sick shard may not drain
                pass
            shard.alive = False
        shard.down_cause = "suspect-slow"
        return self.fail_over(shard_id, cause="suspect-slow")

    # ----------------------------------------------------------------- stats
    def session_count(self) -> int:
        return sum(s.service.session_count for s in self._live_shards())

    def failover_causes(self) -> Dict[str, int]:
        """Event count per failover cause (``killed`` / ``heartbeat`` /
        ``suspect-slow`` / ``partition`` / ``planned``) — the fleet's
        incident mix at a glance."""
        causes: Dict[str, int] = {}
        for event in self.failover_events:
            cause = event.get("cause", "killed")
            causes[cause] = causes.get(cause, 0) + 1
        return causes

    def health(self) -> Dict[str, Any]:
        """Fleet gauges: per-shard health plus liveness/epoch/host,
        membership and suspicion flags, and the failover cause mix."""
        return {
            "shards": {
                s.shard_id: {
                    "alive": s.alive,
                    "epoch": s.epoch,
                    "host": s.host,
                    "failovers": s.failovers,
                    "retired": s.retired,
                    "suspect": s.suspect,
                    "down_cause": s.down_cause,
                    "standby": s.shard_id in self._standbys,
                    **(s.service.health()
                       if s.alive and not s.retired else {}),
                }
                for s in self._shards
            },
            "sessions": self.session_count(),
            "failovers": self.stats["failovers"],
            "handoffs": self.stats["handoffs"],
            "moved_sessions": self.stats["moved_sessions"],
            "failover_causes": self.failover_causes(),
        }

    def slo_snapshot(self) -> Dict[str, Any]:
        """Per-shard SLO views keyed by shard id (sessions are disjoint,
        so per-tenant entries never collide across shards), read
        concurrently on the fleet pool. Retired shards report their
        archived final snapshot — served counts survive scale-in."""
        live = self._live_shards()
        out = dict(zip(
            [s.shard_id for s in live],
            self._fan_out(lambda s: s.service.slo_snapshot(), live),
        ))
        out.update(self._retired_slo)
        return out

    def fleet_snapshot(self) -> Dict[str, Any]:
        """The fabric's telemetry roll-up: per-shard service snapshots
        (read concurrently on the fleet pool), aggregated
        breaker/resilience posture
        (:func:`metrics_tpu_torch.resilience.aggregate_policy_stats`), failover
        history with causes, replication standby cursors, and the fleet
        dollar roll-up under ``"cost"`` (microdollar-exact across
        shards; $/M-updates rendered at this edge)."""
        live = self._live_shards()
        per_shard = dict(zip(
            [s.shard_id for s in live],
            self._fan_out(lambda s: s.service.telemetry_snapshot(), live),
        ))
        totals: Dict[str, int] = {}
        for snap in per_shard.values():
            for k, v in snap["serve"].items():
                totals[k] = totals.get(k, 0) + int(v)
        billed = totals.get("billed_requests", 0)
        cost_micro = totals.get("cost_microusd", 0)
        return {
            "owner": self.label,
            "num_shards": self.num_shards,
            "shards": per_shard,
            "serve_totals": totals,
            # fleet dollar roll-up: integer microdollars summed across
            # shards (lossless — the serve_totals summation above IS the
            # merge), rendered to $ and $/M-updates here at the edge
            "cost": {
                **billing.rate_snapshot(),
                "cost_microusd": cost_micro,
                "cost_usd": billing.usd(cost_micro),
                "billed_requests": billed,
                "usd_per_million_updates": (
                    round(cost_micro / billed, 4) if billed else 0.0
                ),
                "budget_shed": totals.get("budget_shed", 0),
                "budget_rejected": totals.get("budget_rejected", 0),
            },
            "reads": {
                "fleet_reads": self.stats["fleet_reads"],
                "fleet_read_collectives": self.stats["fleet_read_collectives"],
                "memo_hits": totals.get("read_memo_hits", 0),
                "memo_misses": totals.get("read_memo_misses", 0),
            },
            "resilience": resilience.aggregate_policy_stats(
                snap["resilience"] for snap in per_shard.values()
            ),
            "failover_events": list(self.failover_events),
            "failover_causes": self.failover_causes(),
            "replication": {
                sid: {"host": getattr(standby, "host", None),
                      **standby.snapshot()}
                for sid, standby in sorted(self._standbys.items())
            },
            # per-shard always-on latency/throughput aggregates: shard
            # services label their spans "...@shard<id>", so each shard's
            # view is an owner-filtered slice of telemetry.timeline()
            "timeline": {
                s.shard_id: telemetry.timeline(owner=f"@shard{s.shard_id}")
                for s in live
            },
            "health": self.health(),
        }
