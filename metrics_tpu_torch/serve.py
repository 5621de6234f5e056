"""Serving: multi-tenant metric sessions as rows of stacked state.

Port of ``metrics_tpu/serve.py``. A :class:`MetricsService`
is built from ONE template metric; every named session is a row of a
stacked tensor per state leaf (``(capacity, *leaf_shape)``, on the
template's device), and one launch advances every session of a flush.

* **Sessions are rows.** Opening a session takes a free row, closing one
  resets it and frees it; capacity grows by doubling from 64.
* **Request coalescing, one launch.** ``submit()`` enqueues; ``flush()``
  drains the queue, concatenates a session's requests along the batch axis,
  groups them by signature (input layout, trailing shapes and dtypes, the
  padded batch bucket, static flags) and advances every session of a group
  with ONE stacked program: gather the touched rows, update each session
  with the template's masked update (its batch padded to the bucket, the
  pad rows masked out), scatter the rows back. The JAX package ``vmap``s
  the update; the port's kernels are launches that ``vmap`` cannot batch,
  so the program is a loop over the session lanes, and on the card it is
  captured once per signature into **one CUDA graph**: a flush is one graph
  replay. Where the template has a stacked update
  (``_stacked_masked_update``: ``StatScores`` and ``Accuracy``), the loop
  is one session-axis launch of the ``stat_scores`` kernel instead.
* **Pad lanes never leave their scratch row.** The session index of a pad
  lane is ``capacity``, as in the JAX package, whose gather clamps and
  whose scatter drops it. A CUDA index op would assert on it, so each leaf
  is held in a buffer of ``capacity + 1`` rows, the last one a scratch row
  that only pad lanes read and write; ``_stacked`` holds the first
  ``capacity`` rows (views). The replay writes the buffer in place; no
  state tensor is handed out (reads copy), so one buffer serves where the
  engines keep two (:mod:`metrics_tpu_torch.dispatch`).
* **Double-buffered retire.** A launch records a CUDA event; the service
  keeps up to ``max_inflight`` generations pending and waits on the oldest
  one's event when the window fills, never on the whole device. ``drain()``
  waits for all.
* **Checkpoints** hold every session in one npz of ``state::<leaf>`` arrays
  and ``__meta__`` JSON under crc32 checksums
  (:mod:`metrics_tpu_torch.utilities.checksums`), the JAX package's keys and
  meta, so a checkpoint of either package restores in the other.
* **Time travel.** With ``history=HistoryPolicy(...)`` every checkpoint also
  lands as an immutable ladder rung (``<ckpt>.rung-<fence>``, the same npz),
  the journal's truncation floor is pinned to the oldest rung's fence, and
  :meth:`~MetricsService.compute_at` / :meth:`~MetricsService.compute_range`
  rebuild the service as of a wall-clock instant in a scratch service (a
  rung, then the fenced journal replay). :meth:`~MetricsService.scrub`
  verifies the ladder and quarantines (renames, never deletes) a rung that
  fails; ``scrub_interval_s=`` runs it on a ``scrub-worker`` thread.
* **Crash consistency.** With ``journal_dir``, every ``submit()`` appends a
  record to the write-ahead journal (:mod:`metrics_tpu_torch.wal`) before
  the request can be flushed; checkpoints embed the journal's high-water
  mark, and ``restore()`` replays the tail above it exactly once.
* **Admission control**: ``max_queue`` with the ``block`` / ``reject`` /
  ``shed-oldest`` policies, request deadlines, a circuit breaker per
  session and cost budgets per session; every shed, rejected or expired
  request is one cause-tagged ``degrade`` span.
* **Flight recorder**: one ``request`` span per admitted submit with its
  ``queue_us`` / ``journal_us`` / ``launch_us`` / ``retire_us``, the SLO
  sketches (``slo_snapshot()``), ``health()`` and ``memory_snapshot()``.

A stacked launch that fails degrades its group to per-request eager updates
through a :class:`~metrics_tpu_torch.resilience.ResiliencePolicy`. Each
stacked launch is one ``update`` span of kind ``stacked-aot`` with the
program's cost-model and billing attributes; each build one ``compile``
span. The JAX package's persistent program tier (``aot_cache``) has no
counterpart: a CUDA graph cannot be serialized across processes, so every
process captures its graphs anew (the kernels' ``nvcc`` builds persist in
:mod:`metrics_tpu_torch.ops._build`).

Session handles::

    svc = MetricsService(Accuracy(task="multiclass", num_classes=10, device="cpu"))
    svc.submit("model-a", preds, target)     # or svc.session("model-a").update(...)
    svc.flush()
    svc.compute("model-a")
"""
import copy
import gc
import hashlib
import json
import os
import shutil
import threading
import time
import zlib
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch import faults, resilience, telemetry, wal
from metrics_tpu_torch.analysis import billing, cost_model
from metrics_tpu_torch.dispatch import _flatten, _unflatten, cache_max, copy_tensors
from metrics_tpu_torch.ops import registry
from metrics_tpu_torch.utilities.checks import tracing
from metrics_tpu_torch.utilities.checksums import CHECKSUM_PREFIX, attach_checksums, verify_checksums
from metrics_tpu_torch.utilities.data import bucket_pow2, dtype_name

__all__ = [
    "MetricsService",
    "ShardedCapacityService",
    "MetricSession",
    "ValueTicket",
    "QueueFullError",
    "CircuitOpenError",
    "CostBudgetExceededError",
    "HistoryPolicy",
]

_MIN_SESSION_BUCKET = 8
_MIN_CAPACITY = 64

_ADMISSION_POLICIES = ("block", "reject", "shed-oldest")


class QueueFullError(RuntimeError):
    """Admission control rejected a submit: the bounded queue is full and
    the policy is ``reject`` (or ``block`` timed out)."""


class CircuitOpenError(RuntimeError):
    """The per-session circuit breaker is open: this session failed
    repeatedly and is in backoff cooldown (counted in submits)."""


class CostBudgetExceededError(RuntimeError):
    """This session's trailing spend rate exceeds its configured
    ``cost_budget_usd_per_s`` and its admission posture rejects the
    submit. The guard re-admits as soon as the trailing-window spend falls
    back under budget."""


# sentinel for configure_session(): "leave this override untouched"
_UNSET = object()


class HistoryPolicy:
    """Checkpoint-ladder retention for point-in-time reads.

    With ``MetricsService(history=HistoryPolicy(...))`` every checkpoint also
    lands as an immutable ladder rung (``<ckpt>.rung-<fence>``, the fence the
    checkpoint's ``journal_seq``) beside the newest checkpoint, and the
    journal's truncation floor is pinned to the oldest retained rung's fence,
    so every rung keeps a contiguous replay tail.

    Args:
        keep_last: always retain the newest N rungs (N >= 1).
        keep_per_interval_s: among older rungs, also keep the newest rung of
            each wall-clock interval of this many seconds (``None``: older
            rungs are collected outright).
    """

    __slots__ = ("keep_last", "keep_per_interval_s")

    def __init__(self, keep_last: int = 3, keep_per_interval_s: Optional[float] = None) -> None:
        self.keep_last = int(keep_last)
        if self.keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        self.keep_per_interval_s = None if keep_per_interval_s is None else float(keep_per_interval_s)
        if self.keep_per_interval_s is not None and self.keep_per_interval_s <= 0:
            raise ValueError(
                f"keep_per_interval_s must be positive, got {keep_per_interval_s}"
            )

    def __repr__(self) -> str:
        return (
            f"HistoryPolicy(keep_last={self.keep_last}, "
            f"keep_per_interval_s={self.keep_per_interval_s})"
        )


class ValueTicket:
    """Handle for one ``submit(..., return_value=True)``'s batch value.

    The value is the template metric evaluated over that request's batch
    alone (forward semantics), produced by the same stacked launch that
    advances the session state. :meth:`result` blocks until the request's
    launch generation retires; a shed / expired / failed request resolves
    the ticket with the failure instead of hanging its waiter."""

    __slots__ = ("_event", "_value", "_error")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None

    def _resolve(self, value: Any) -> None:
        if not self._event.is_set():
            self._value = value
            self._event.set()

    def _reject(self, error: BaseException) -> None:
        if not self._event.is_set():
            self._error = error
            self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        """The batch value (blocks until retirement; raises the request's
        failure for shed/expired/failed outcomes)."""
        if not self._event.wait(timeout):
            raise TimeoutError("request value is not ready; call flush()/drain()")
        if self._error is not None:
            raise self._error
        return self._value


class _Request:
    """One admitted submit's flight record, from the queue through
    coalescing and the stacked launch to retirement."""

    __slots__ = (
        "name", "args", "kwargs", "seq", "rid", "t_enq", "t0", "submit_tid",
        "journal_us", "queue_us", "launch_us", "launch_ts_us", "launch_tid",
        "t_launch_done", "replayed", "members", "deadline_s", "ticket", "value",
        "rows", "cost_microusd",
    )

    def __init__(
        self,
        name: str,
        args: Tuple,
        kwargs: Dict,
        seq: Optional[int],
        rid: int,
        t_enq: float,
        t0: Optional[float],
        submit_tid: int,
        *,
        journal_us: float = 0.0,
        replayed: bool = False,
        deadline_s: Optional[float] = None,
        ticket: Optional[ValueTicket] = None,
    ) -> None:
        self.name = name
        self.args = args
        self.kwargs = kwargs
        self.seq = seq
        self.rid = rid
        self.t_enq = t_enq
        self.t0 = t0
        self.submit_tid = submit_tid
        self.journal_us = journal_us
        self.queue_us = 0.0
        self.launch_us = 0.0
        self.launch_ts_us: Optional[float] = None
        self.launch_tid: Optional[int] = None
        self.t_launch_done: Optional[float] = None
        self.replayed = replayed
        self.deadline_s = deadline_s
        self.ticket = ticket
        self.value: Any = None
        # the batch rows this request added to its launch: its weight when the launch's cost is split
        self.rows = 0
        self.cost_microusd = 0
        # a coalesced merge keeps its member requests, each of which retires on its own
        self.members: Optional[List["_Request"]] = None

    def all(self) -> List["_Request"]:
        return self.members if self.members is not None else [self]


class _SessionSLO:
    """Per-tenant latency and outcome accounting, host-side and always on."""

    __slots__ = ("e2e_us", "queue_us", "counts", "cost_microusd", "billed")

    _OUTCOMES = (
        "served", "fallback", "shed", "expired",
        "rejected", "failed", "breaker_rejected",
    )

    def __init__(self) -> None:
        from metrics_tpu_torch.streaming.sketch import HostQuantileSketch

        # alpha=0.05 over 512 bins a sign spans sub-µs to hours at 5% relative error
        self.e2e_us = HostQuantileSketch(bins=512, alpha=0.05)
        self.queue_us = HostQuantileSketch(bins=512, alpha=0.05)
        self.counts: Dict[str, int] = {k: 0 for k in self._OUTCOMES}
        self.cost_microusd = 0
        self.billed = 0

    def record(
        self,
        outcome: str,
        e2e_us: Optional[float] = None,
        queue_us: Optional[float] = None,
        cost_microusd: Optional[int] = None,
    ) -> None:
        self.counts[outcome] = self.counts.get(outcome, 0) + 1
        if e2e_us is not None:
            self.e2e_us.add(e2e_us)
        if queue_us is not None:
            self.queue_us.add(queue_us)
        if cost_microusd is not None:
            self.cost_microusd += int(cost_microusd)
            self.billed += 1

    def snapshot(self) -> Dict[str, Any]:
        snap = {
            "e2e_us": self.e2e_us.snapshot(),
            "queue_us": self.queue_us.snapshot(),
            **self.counts,
        }
        if billing.billing_enabled():
            snap["cost_microusd"] = self.cost_microusd
            snap["cost_usd"] = billing.usd(self.cost_microusd)
            snap["usd_per_million_updates"] = (
                round(self.cost_microusd / self.billed, 4) if self.billed else 0.0
            )
        return snap


class _CostBudget:
    """Trailing-window spend-rate guard for one tenant: retirements charge
    integer microdollars, and the guard re-admits on its own once the
    trailing spend rate falls back under the budget."""

    __slots__ = ("budget_usd_per_s", "window_s", "_events", "_lock", "tripped", "trips")

    #: the horizon the spend rate is averaged over
    WINDOW_S = 0.25

    def __init__(self, budget_usd_per_s: float, window_s: Optional[float] = None) -> None:
        self.budget_usd_per_s = float(budget_usd_per_s)
        self.window_s = float(window_s if window_s is not None else self.WINDOW_S)
        self._events: deque = deque()  # (monotonic ts, microusd)
        self._lock = threading.Lock()
        self.tripped = False
        self.trips = 0

    def charge(self, microusd: int) -> None:
        if microusd > 0:
            with self._lock:
                self._events.append((time.monotonic(), int(microusd)))

    def spend_usd_per_s(self) -> float:
        """Trailing-window spend rate in $/s (prunes expired charges)."""
        now = time.monotonic()
        with self._lock:
            while self._events and self._events[0][0] < now - self.window_s:
                self._events.popleft()
            total = sum(m for _, m in self._events)
        return total / billing.MICRO_PER_USD / self.window_s

    def over_budget(self) -> bool:
        over = self.spend_usd_per_s() > self.budget_usd_per_s
        if over and not self.tripped:
            self.trips += 1
        self.tripped = over
        return over

    def snapshot(self) -> Dict[str, Any]:
        spend = self.spend_usd_per_s()
        return {
            "budget_usd_per_s": self.budget_usd_per_s,
            "spend_usd_per_s": round(spend, 6),
            "over_budget": spend > self.budget_usd_per_s,
            "trips": int(self.trips),
        }


class MetricSession:
    """Thin named handle over one service row: ``update`` submits to the
    shared queue, ``compute`` flushes pending work and evaluates the row."""

    def __init__(self, service: "MetricsService", name: str) -> None:
        self._service = service
        self.name = name

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._service.submit(self.name, *args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        return self._service.forward(self.name, *args, **kwargs)

    def compute(self) -> Any:
        return self._service.compute(self.name)

    def close(self) -> None:
        self._service.close_session(self.name)


class _StackedLayoutError(RuntimeError):
    """The stacked update changed a state leaf's shape or dtype."""


class _StackedProgram:
    """One signature's stacked update: the program, and on the card its graph
    and the static buffers the graph reads (the session index, the row counts,
    the inputs)."""

    __slots__ = ("body", "graph", "idx", "n_valid", "inputs", "values", "launched", "arg_bytes", "out_bytes",
                 "peak_temp_bytes", "cost", "build")

    def __init__(self, body: Callable) -> None:
        self.body = body  # (phys leaves, idx, n_valid, flat inputs) -> stacked batch values or None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.idx: Optional[Tensor] = None
        self.n_valid: Optional[Tensor] = None
        self.inputs: List[Tensor] = []
        self.values: Any = None  # the graph's value outputs, overwritten by each replay
        self.launched: List[registry.Launch] = []  # the kernel launches one replay runs
        # the cost model's terms (analysis/cost_model.py::record): the inputs and gathered rows read, the rows
        # written, the bytes the graph's pool keeps; and the entry made of them
        self.arg_bytes = self.out_bytes = self.peak_temp_bytes = 0
        self.cost: Optional[cost_model.CostEntry] = None
        self.build: Optional[Tuple[str, float]] = None  # on the card, until the capture: the build's cause and start


# one capture at a time in a process: a fleet's shards flush on a thread pool and may reach their first
# launches together. Replays and eager work on other threads go on meanwhile (thread-local capture mode).
_CAPTURE_LOCK = threading.Lock()


def capture_graph(run: Callable[[], Any], pool: Any) -> Tuple[Any, Any, List[registry.Launch]]:
    """Capture ``run`` into one CUDA graph on a side stream, in thread-local
    mode, into the memory ``pool``: ``(graph, run's outputs, the registry
    launches it made, written down)``. The capture runs nothing. Garbage
    collection is off meanwhile (a graph freed during a capture spoils it)."""
    with _CAPTURE_LOCK:
        collecting = gc.isenabled()
        gc.disable()
        try:
            graph = torch.cuda.CUDAGraph()
            with registry.recording() as launched, tracing(), \
                    torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                values = run()
            return graph, values, launched
        finally:
            if collecting:
                gc.enable()


def warm_run(side: Any, fn: Callable[[], Any]) -> Any:
    """A program's warm-up run on the card: ``fn`` on the stream ``side``
    after the current stream's queued work, with value checks skipped; its
    outputs copied and ordered before the current stream's later work. It
    builds the kernels and warms the allocator outside a capture."""
    current = torch.cuda.current_stream(side.device)
    side.wait_stream(current)
    with torch.cuda.stream(side), tracing():
        out = copy_tensors(fn())
    current.wait_stream(side)
    for v in _flatten(out)[0]:
        if isinstance(v, Tensor):
            v.record_stream(current)
    return out


def _nbytes(t: Tensor) -> int:
    return t.numel() * t.element_size()


def _stack_values(lanes: List[Any]) -> Any:
    """Per-lane value trees stacked leaf by leaf into one tree of ``(S, ...)``
    tensors (the list itself where a leaf is no tensor)."""
    flat = [_flatten(v) for v in lanes]
    if not flat or any(not isinstance(x, Tensor) for leaves, _ in flat for x in leaves):
        return lanes
    layout = flat[0][1]
    return _unflatten(layout, [torch.stack([leaves[j] for leaves, _ in flat]) for j in range(len(flat[0][0]))])


def _lane_value(vals: Any, i: int) -> Any:
    if isinstance(vals, list):
        return vals[i]
    leaves, layout = _flatten(vals)
    return _unflatten(layout, [x[i] for x in leaves])


class MetricsService:
    """Multi-tenant evaluation service over one template metric.

    Args:
        template: the port's metric whose update and compute define every
            session. Its state must be fixed-shape tensors (a list state
            raises ``TypeError``); a ``MetricCollection`` is rejected (one
            service per member). The stacked state lives on the template's
            device (``cuda`` unless the template was built with
            ``device="cpu"``), and submitted tensors are moved there.
        coalesce: concatenate same-session requests along the batch axis
            (forced off for a streaming-window template: a submit is a tick).
        checkpoint_dir: directory of the periodic checkpoints.
        checkpoint_every: write a checkpoint every N flushes (0 = never).
        max_inflight: pending launch generations before the service waits on
            the oldest one's event (double buffering at the default 2).
        journal_dir: write-ahead-journal directory (:mod:`metrics_tpu_torch.wal`);
            ``METRICS_TPU_WAL=0`` keeps checkpoint-only durability.
        max_queue: submit-queue bound (``None`` = unbounded).
        admission: ``"block"`` (wait up to ``admission_timeout_s``, then
            :class:`QueueFullError`), ``"reject"`` or ``"shed-oldest"``.
        admission_timeout_s: the longest a ``block`` submit waits.
        request_deadline_s: queued requests older than this at flush time
            expire instead of being served.
        flush_interval_s: with a value, a daemon ``flush-worker`` thread
            flushes every interval; :meth:`shutdown` stops it.
        scrub_interval_s: with a value, a daemon ``scrub-worker`` thread runs
            :meth:`scrub` over the checkpoint ladder every interval (under the
            flush lock); its run and error counts and its latest report are
            ``telemetry_snapshot()["history"]``.
        shard_id, rid_offset, rid_stride, epoch: the shard this service hosts
            (a telemetry tag), its request-id lattice, and the journal's
            ownership epoch (:class:`~metrics_tpu_torch.wal.WriteAheadLog`).
        shard_capacity: an int ``N > 1`` returns a
            :class:`ShardedCapacityService` (N stacks, crc32 routing).
        history: a :class:`HistoryPolicy` keeps a ladder of past checkpoints
            for :meth:`compute_at`, :meth:`compute_range` and :meth:`scrub`.
    """

    def __new__(cls, *args: Any, **kwargs: Any) -> "MetricsService":
        # shard_capacity is a constructor-level layout choice: a facade over N stacked services
        if cls is MetricsService and int(kwargs.get("shard_capacity") or 1) > 1:
            return super().__new__(ShardedCapacityService)
        return super().__new__(cls)

    def __init__(
        self,
        template: Any,
        *,
        coalesce: bool = True,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        max_inflight: int = 2,
        journal_dir: Optional[str] = None,
        max_queue: Optional[int] = None,
        admission: str = "block",
        admission_timeout_s: Optional[float] = None,
        request_deadline_s: Optional[float] = None,
        flush_interval_s: Optional[float] = None,
        scrub_interval_s: Optional[float] = None,
        shard_id: Optional[int] = None,
        rid_offset: int = 0,
        rid_stride: int = 1,
        epoch: int = 0,
        shard_capacity: Optional[int] = None,
        history: Optional[HistoryPolicy] = None,
    ) -> None:
        del shard_capacity  # > 1 went to ShardedCapacityService in __new__
        from metrics_tpu_torch.collections import MetricCollection
        from metrics_tpu_torch.metric import Metric

        if isinstance(template, MetricCollection):
            raise TypeError(
                "MetricsService takes a single Metric template; build one service "
                "per collection member (stacked session rows need one flat leaf "
                "layout per session)"
            )
        if not isinstance(template, Metric):
            raise TypeError(f"template must be a Metric, got {type(template).__name__}")
        if history is not None and not isinstance(history, HistoryPolicy):
            raise TypeError(
                f"history must be a HistoryPolicy (or None), got {type(history).__name__}"
            )
        defaults = template.default_state()
        for name, leaf in defaults.items():
            if isinstance(leaf, list):
                raise TypeError(
                    f"template state {name!r} is a list state; sessions need "
                    "fixed-shape array state to stack"
                )
        if admission not in _ADMISSION_POLICIES:
            raise ValueError(
                f"admission must be one of {_ADMISSION_POLICIES}, got {admission!r}"
            )
        self.template = template
        self.device = template.device
        self.shard_id = shard_id
        self.epoch = int(epoch)
        self.label = f"MetricsService[{type(template).__name__}]" + (
            f"@shard{shard_id}" if shard_id is not None else ""
        )
        from metrics_tpu_torch.streaming.window import _StreamingWindow

        # a window counts updates (a submit is one tick): merging two would change its horizon
        self.coalesce = coalesce and not isinstance(template, _StreamingWindow)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)
        self.history = history
        self.max_inflight = max(1, int(max_inflight))
        self.journal_dir = journal_dir
        self.max_queue = None if max_queue is None else max(1, int(max_queue))
        self.admission = admission
        self.admission_timeout_s = admission_timeout_s
        self.request_deadline_s = request_deadline_s

        self._names: List[str] = list(defaults)
        self._default_rows: Dict[str, Tensor] = {k: defaults[k].to(self.device) for k in self._names}
        self._capacity = _MIN_CAPACITY
        self._phys: Dict[str, Tensor] = {}
        self._stacked: Dict[str, Tensor] = {}
        self._alloc_rows(self._capacity)
        self._rows: Dict[str, int] = {}
        self._free: List[int] = list(range(self._capacity - 1, -1, -1))
        # read-path memo: a version per row (bumped by every write) and each session's last value, keyed
        # (row version, epoch)
        self._row_version: List[int] = [0] * self._capacity
        self._memo: Dict[str, Tuple[int, int, Any]] = {}

        # the queue of _Request records; its condition is the queue lock, and request ids are minted under it
        self._queue: List[_Request] = []
        self._queue_cond = threading.Condition()
        self._rid_stride = max(1, int(rid_stride))
        self._rid = int(rid_offset)
        self._slo: Dict[str, _SessionSLO] = {}
        self._slo_lock = threading.Lock()
        # reentrant: the periodic checkpoint inside flush() drains, and drain() flushes. It also serialises
        # every use of the template (a pure update or compute loads a state into it for the call)
        self._flush_lock = threading.RLock()
        self._inflight: deque = deque()

        self._wal: Optional[wal.WriteAheadLog] = None
        if journal_dir is not None and wal.wal_enabled():
            self._wal = wal.WriteAheadLog(journal_dir, owner=self.label, epoch=self.epoch)
        self._tenant_cfg: Dict[str, Dict[str, Any]] = {}
        self._budgets: Dict[str, _CostBudget] = {}
        # explicitly closed names: submit() raises until open_session() reclaims one
        self._closed: set = set()
        self._breakers: Dict[str, resilience.ResiliencePolicy] = {}
        # True while restore() replays the journal: no journaling, no expiry, no periodic checkpoint
        self._replaying = False

        self._exec_cache: "OrderedDict[Tuple, _StackedProgram]" = OrderedDict()
        # compute_all's programs by dirty-row bucket
        self._compute_stack: Dict[int, _StackedProgram] = {}
        self._seen_signatures: set = set()
        self._policy = resilience.ResiliencePolicy()
        self._pool: Any = None
        self._side_stream: Optional[Any] = None
        self._flushes = 0
        self.stats: Dict[str, int] = {
            "submits": 0,
            "flushes": 0,
            "launches": 0,
            "coalesced_requests": 0,
            "fallback_requests": 0,
            "retraces": 0,
            "checkpoints": 0,
            "evictions": 0,
            "shed_requests": 0,
            "rejected_requests": 0,
            "expired_requests": 0,
            "breaker_rejected": 0,
            "failed_requests": 0,
            "replayed_records": 0,
            "read_memo_hits": 0,
            "read_memo_misses": 0,
            "cost_microusd": 0,
            "billed_requests": 0,
            "budget_shed": 0,
            "budget_rejected": 0,
        }

        self.flush_interval_s = flush_interval_s
        self._stop_flush = threading.Event()
        self._flush_thread: Optional[threading.Thread] = None
        if flush_interval_s is not None:
            self._flush_thread = threading.Thread(
                target=self._flush_loop, name="flush-worker", daemon=True
            )
            self._flush_thread.start()

        self.scrub_interval_s = scrub_interval_s
        self._scrub_stats: Dict[str, Any] = {"runs": 0, "errors": 0, "last": None}
        self._stop_scrub = threading.Event()
        self._scrub_thread: Optional[threading.Thread] = None
        if scrub_interval_s is not None:
            self._scrub_thread = threading.Thread(
                target=self._scrub_loop, name="scrub-worker", daemon=True
            )
            self._scrub_thread.start()

    def _scrub_loop(self) -> None:
        telemetry.set_thread_name("scrub-worker")
        while not self._stop_scrub.wait(self.scrub_interval_s):
            try:
                # a rung is never verified while the periodic checkpoint inside flush() writes it
                with self._flush_lock:
                    report = self.scrub()
                self._scrub_stats["runs"] += 1
                self._scrub_stats["last"] = report
            except Exception as err:  # noqa: BLE001 - the worker must survive a failed pass
                self._scrub_stats["errors"] += 1
                resilience.record_degrade(self.label, "history", err, stage="scrub-worker")

    def _flush_loop(self) -> None:
        telemetry.set_thread_name("flush-worker")
        while not self._stop_flush.wait(self.flush_interval_s):
            try:
                if self.flush() == 0:
                    # a quiet interval still retires what the device finished
                    self._retire_all()
            except Exception as err:  # noqa: BLE001 - the worker must survive a poisoned flush
                resilience.record_degrade(self.label, "flush-worker", err)

    def shutdown(self) -> None:
        """Stop the background flush and scrub workers (if any), then flush
        and retire everything outstanding. Idempotent."""
        self._stop_flush.set()
        self._stop_scrub.set()
        if self._flush_thread is not None:
            self._flush_thread.join(timeout=5.0)
            self._flush_thread = None
        if self._scrub_thread is not None:
            self._scrub_thread.join(timeout=5.0)
            self._scrub_thread = None
        self.drain()

    # -------------------------------------------------------------- state rows
    def _alloc_rows(self, capacity: int, rows: Optional[Dict[str, Any]] = None) -> None:
        """(Re)build each leaf's buffer of ``capacity + 1`` rows: the given rows
        (tensors or numpy arrays, first ones) or defaults, then the scratch row."""
        for k in self._names:
            default = self._default_rows[k]
            buf = default[None].expand((capacity + 1,) + tuple(default.shape)).clone()
            if rows is not None:
                src = rows[k]
                src = src if isinstance(src, Tensor) else torch.from_numpy(np.array(src))
                buf[: src.shape[0]].copy_(src.to(self.device))
            self._phys[k] = buf
            self._stacked[k] = buf[:capacity]

    def _write_row(self, row: int, values: Dict[str, Any]) -> None:
        for k in self._names:
            v = values[k]
            v = v if isinstance(v, Tensor) else torch.from_numpy(np.array(v))
            self._phys[k][row].copy_(v.to(self.device))
        self._row_version[row] += 1

    def _drop_programs(self) -> None:
        """Programs read the buffers by address: a new buffer retires them."""
        self._exec_cache.clear()
        self._compute_stack = {}

    # -------------------------------------------------------------- sessions
    @property
    def session_count(self) -> int:
        return len(self._rows)

    def session(self, name: str) -> MetricSession:
        """Named handle (opens the session lazily on first use)."""
        return MetricSession(self, name)

    def open_session(self, name: str) -> int:
        """Assign a state row to ``name`` (idempotent); returns the row.
        Explicitly reclaims a name retired by :meth:`close_session`."""
        self._closed.discard(name)
        row = self._rows.get(name)
        if row is not None:
            return row
        if not self._free:
            self._grow()
        row = self._free.pop()
        self._rows[name] = row
        return row

    def close_session(self, name: str) -> None:
        """Release ``name``'s row back to the pool (state reset to default).
        Further :meth:`submit` calls for the name raise ``KeyError`` until
        :meth:`open_session` reclaims it."""
        if not self._replaying:
            # journal order: updates journaled before this CLOSE apply before it
            self.flush()
        with self._flush_lock:
            row = self._rows.pop(name, None)
            if row is None:
                return
            self._closed.add(name)
            self._breakers.pop(name, None)
            if self._wal is not None and not self._replaying:
                self._wal.append(wal.CLOSE, name)
            self._write_row(row, self._default_rows)
            self._memo.pop(name, None)
            self._free.append(row)

    def reset_session(self, name: str) -> None:
        """Reset one session's accumulator to the default state. Also clears
        the session's circuit breaker."""
        if not self._replaying:
            self.flush()
        with self._flush_lock:
            row = self.open_session(name)
            if self._wal is not None and not self._replaying:
                self._wal.append(wal.RESET, name)
            self._breakers.pop(name, None)
            self._write_row(row, self._default_rows)
            self._memo.pop(name, None)

    def _grow(self) -> None:
        old = self._capacity
        self._capacity = old * 2
        self._alloc_rows(self._capacity, rows={k: self._stacked[k] for k in self._names})
        self._free.extend(range(self._capacity - 1, old - 1, -1))
        self._row_version.extend([0] * old)
        # capacity is part of every program's key (and the buffers moved)
        self._drop_programs()

    # --------------------------------------------------------------- intake
    def configure_session(
        self,
        name: str,
        *,
        request_deadline_s: Any = _UNSET,
        admission: Any = _UNSET,
        cost_budget_usd_per_s: Any = _UNSET,
    ) -> None:
        """Per-tenant overrides of the service-wide admission posture:
        ``request_deadline_s`` (``None``: this tenant never expires),
        ``admission`` (``None``: back to the service default) and
        ``cost_budget_usd_per_s`` (a spend-rate guard; ``None`` disarms).
        Unset arguments leave the existing override untouched. Overrides are
        routing metadata, not state, and are not journaled."""
        if admission is not _UNSET and admission is not None:
            if admission not in _ADMISSION_POLICIES:
                raise ValueError(
                    f"admission must be one of {_ADMISSION_POLICIES}, got {admission!r}"
                )
        cfg = self._tenant_cfg.setdefault(name, {})
        if request_deadline_s is not _UNSET:
            cfg["request_deadline_s"] = request_deadline_s
        if admission is not _UNSET:
            cfg["admission"] = admission
        if cost_budget_usd_per_s is not _UNSET:
            cfg["cost_budget_usd_per_s"] = cost_budget_usd_per_s
            if cost_budget_usd_per_s is None:
                self._budgets.pop(name, None)
            else:
                budget = float(cost_budget_usd_per_s)
                if budget <= 0:
                    raise ValueError(
                        f"cost_budget_usd_per_s must be positive (or None to "
                        f"disarm), got {cost_budget_usd_per_s!r}"
                    )
                guard = self._budgets.get(name)
                if guard is None:
                    self._budgets[name] = _CostBudget(budget)
                else:
                    guard.budget_usd_per_s = budget

    def session_config(self, name: str) -> Dict[str, Any]:
        """Effective admission config for one session (overrides folded
        over the service defaults)."""
        cfg = self._tenant_cfg.get(name, {})
        return {
            "request_deadline_s": cfg.get(
                "request_deadline_s", self.request_deadline_s
            ),
            "admission": cfg.get("admission") or self.admission,
            "cost_budget_usd_per_s": cfg.get("cost_budget_usd_per_s"),
        }

    def _to_device(self, tree: Any) -> Any:
        """Array leaves as tensors on the service's device: numpy arrays and
        scalars in the JAX package's 32-bit dtypes, tensors moved where they
        lie elsewhere; Python numbers and strings stay."""
        def leaf(x: Any) -> Any:
            if isinstance(x, Tensor):
                return x if x.device == self.device else x.to(self.device)
            if isinstance(x, (np.ndarray, np.generic)):
                arr = np.asarray(x)
                if arr.dtype == np.float64:
                    arr = arr.astype(np.float32)
                elif arr.dtype == np.int64:
                    arr = arr.astype(np.int32)
                return torch.from_numpy(np.array(arr)).to(self.device)
            return x

        leaves, layout = _flatten(tree)
        return _unflatten(layout, [leaf(x) for x in leaves])

    def submit(
        self, name: str, *args: Any, return_value: bool = False, **kwargs: Any
    ) -> Optional[ValueTicket]:
        """Enqueue one update for session ``name`` (thread-safe; the device
        work happens at the next :meth:`flush`).

        Gates, in order: a closed session raises ``KeyError``; an open
        circuit breaker :class:`CircuitOpenError`; an over-budget tenant is
        shed or rejected (:class:`CostBudgetExceededError`); a full bounded
        queue engages the admission policy. Only an admitted request is
        journaled, and it is durable before it can be flushed.

        With ``return_value=True`` the returned :class:`ValueTicket`
        resolves at retirement to the metric's value over this batch alone,
        computed by the same stacked launch that advances the session."""
        if name in self._closed:
            raise KeyError(
                f"session {name!r} has been closed; call open_session({name!r}) "
                "to reuse the name"
            )
        breaker = self._breakers.get(name)
        if breaker is not None and not breaker.allow():
            self.stats["breaker_rejected"] += 1
            self._slo_record(name, "breaker_rejected")
            telemetry.emit(
                "degrade", self.label, kind="session", cause="breaker-open",
                session=name, cooldown=breaker.cooldown,
            )
            raise CircuitOpenError(
                f"session {name!r} circuit breaker is open after "
                f"{breaker.failures} failure(s); retry after the cooldown "
                f"({breaker.cooldown} more submits) or reset_session()"
            )
        guard = self._budgets.get(name)
        if guard is not None and billing.billing_enabled() and guard.over_budget():
            # the over-budget tenant's own submit is the victim; "block" maps to reject
            cfg = self._tenant_cfg.get(name)
            policy = (cfg.get("admission") if cfg else None) or self.admission
            spend = round(guard.spend_usd_per_s(), 6)
            telemetry.emit(
                "degrade", self.label, kind="admission", cause="cost-budget",
                session=name, policy=policy, spend_usd_per_s=spend,
                budget_usd_per_s=guard.budget_usd_per_s,
            )
            if policy == "shed-oldest":
                self.stats["budget_shed"] += 1
                self._slo_record(name, "shed")
                if return_value:
                    ticket = ValueTicket()
                    ticket._reject(CostBudgetExceededError(
                        f"session {name!r} submit shed: spend "
                        f"{spend} $/s exceeds its cost budget "
                        f"{guard.budget_usd_per_s} $/s"
                    ))
                    return ticket
                return None
            self.stats["budget_rejected"] += 1
            self._slo_record(name, "rejected")
            raise CostBudgetExceededError(
                f"session {name!r} spend {spend} $/s exceeds its cost "
                f"budget {guard.budget_usd_per_s} $/s; re-admission is "
                f"automatic once trailing spend falls under budget"
            )
        self.open_session(name)
        cfg = self._tenant_cfg.get(name)
        deadline_s = self.request_deadline_s
        if cfg is not None and "request_deadline_s" in cfg:
            deadline_s = cfg["request_deadline_s"]
        ticket = ValueTicket() if return_value else None
        t0 = telemetry.clock()
        dev_args, dev_kwargs = self._to_device(args), self._to_device(kwargs)  # outside the lock: may copy
        with self._queue_cond:
            if self.max_queue is not None and len(self._queue) >= self.max_queue:
                self._admit_locked(name)
            self._rid += self._rid_stride
            rid = self._rid
            seq: Optional[int] = None
            journal_us = 0.0
            if self._wal is not None and not self._replaying:
                j0 = time.monotonic()
                seq = self._wal.append(wal.UPDATE, name, args, kwargs, request_id=rid)
                journal_us = (time.monotonic() - j0) * 1e6
                faults.crash_point("post-journal", self.label)
            self._queue.append(_Request(
                name, dev_args, dev_kwargs, seq, rid,
                time.monotonic(), t0, threading.get_ident(),
                journal_us=journal_us, deadline_s=deadline_s, ticket=ticket,
            ))
            self.stats["submits"] += 1
        return ticket

    def _admit_locked(self, name: str) -> None:
        """Resolve a full queue under the submitting session's admission
        policy (queue condition held): return with space, or raise
        :class:`QueueFullError`. Each victim or rejection is one cause-tagged
        ``degrade`` span; a shed victim also gets a journal ``DROP``."""
        assert self.max_queue is not None
        cfg = self._tenant_cfg.get(name)
        policy = (cfg.get("admission") if cfg else None) or self.admission
        if policy == "shed-oldest":
            while len(self._queue) >= self.max_queue:
                victim = self._queue.pop(0)
                if self._wal is not None and victim.seq is not None:
                    self._wal.append(
                        wal.DROP, victim.name,
                        drop_seq=victim.seq, drop_cause="queue-full-shed",
                    )
                self.stats["shed_requests"] += 1
                telemetry.emit(
                    "degrade", self.label, kind="admission",
                    cause="queue-full-shed", session=victim.name, seq=victim.seq,
                )
                self._finish_request(victim, "shed")
            return
        if policy == "block":
            deadline = (
                None
                if self.admission_timeout_s is None
                else time.monotonic() + self.admission_timeout_s
            )
            while len(self._queue) >= self.max_queue:
                timeout = None if deadline is None else deadline - time.monotonic()
                if timeout is not None and timeout <= 0:
                    break
                self._queue_cond.wait(timeout)
            if len(self._queue) < self.max_queue:
                return
        self.stats["rejected_requests"] += 1
        self._slo_record(name, "rejected")
        telemetry.emit(
            "degrade", self.label, kind="admission", cause="queue-full-reject",
            session=name, policy=policy,
        )
        raise QueueFullError(
            f"submit queue is full ({self.max_queue} requests); admission "
            f"policy {policy!r} rejected session {name!r}"
        )

    def update(self, name: str, *args: Any, **kwargs: Any) -> None:
        """Synchronous convenience: submit + flush."""
        self.submit(name, *args, **kwargs)
        self.flush()

    def forward(self, name: str, *args: Any, **kwargs: Any) -> Any:
        """Synchronous forward: advance session ``name`` with the batch AND
        return the metric's value over this batch alone, served by the
        stacked launch."""
        ticket = self.submit(name, *args, return_value=True, **kwargs)
        self.drain()
        assert ticket is not None
        return ticket.result()

    # ---------------------------------------------------------------- flush
    def flush(self) -> int:
        """Drain the request queue into stacked launches; returns the number
        of requests served. Coalesces same-session requests, groups by
        signature, and issues ONE launch per group per wave."""
        with self._flush_lock:
            with self._queue_cond:
                queued, self._queue = self._queue, []
                self._queue_cond.notify_all()
            if not queued:
                return 0
            self._maybe_slow()
            now = time.monotonic()
            for req in queued:
                req.queue_us = max(0.0, (now - req.t_enq) * 1e6)
            pending = self._expire_stale(queued)
            if not pending:
                return 0
            served = len(pending)
            if self.coalesce:
                pending = self._coalesce(pending)
            # a session appears once a launch (its row is gathered and scattered once): duplicates left after
            # coalescing serialise across waves
            while pending:
                wave: "OrderedDict[str, _Request]" = OrderedDict()
                rest: List[_Request] = []
                for req in pending:
                    if req.name in wave:
                        rest.append(req)
                    else:
                        wave[req.name] = req
                self._run_wave(list(wave.values()))
                faults.crash_point("mid-flush", self.label)
                pending = rest
            self._flushes += 1
            self.stats["flushes"] += 1
            self._emit_gauges()
            if (
                not self._replaying
                and self.checkpoint_every > 0
                and self.checkpoint_dir is not None
                and self._flushes % self.checkpoint_every == 0
            ):
                try:
                    self.checkpoint()
                except Exception as err:  # noqa: BLE001 - checkpointing must never take serving down
                    resilience.record_degrade(self.label, "checkpoint", err)
            return served

    def _maybe_slow(self) -> None:
        """The ``shard-slow`` seam: while a spec targets this shard (param
        ``shard``, default any), a flush that found work sleeps ``ms``
        (default 25) first. The service stays correct, only slow."""
        if not faults.any_active():
            return
        params = faults.fault_params("shard-slow")
        target = params.get("shard")
        if target is not None and self.shard_id is not None and int(target) != self.shard_id:
            return
        if faults.should_fire("shard-slow"):
            time.sleep(float(params.get("ms", 25.0)) * 1e-3)

    def drain(self) -> None:
        """Barrier: flush the queue and wait until every launch retired."""
        self.flush()
        self._retire_all()

    def _retire_all(self) -> None:
        """Retire every inflight generation (``popleft`` is the atomic claim:
        the caller and the flush worker may race here)."""
        while True:
            try:
                generation = self._inflight.popleft()
            except IndexError:
                return
            self._retire(generation)

    def _retire(self, generation: Tuple[Any, List[_Request]]) -> None:
        """Wait for one generation's launch (its CUDA event: never the whole
        device), then close every request it carried."""
        event, reqs = generation
        if event is not None:
            event.synchronize()
        t_ret = time.monotonic()
        for req in reqs:
            self._finish_request(req, "served", t_ret=t_ret)

    def _expire_stale(self, queued: List[_Request]) -> List[_Request]:
        """Queued requests older than their deadline expire (one
        ``deadline-expired`` degrade span and journal ``DROP`` each); replayed
        records never do."""
        if self._replaying or all(req.deadline_s is None for req in queued):
            return queued
        now = time.monotonic()
        live: List[_Request] = []
        for req in queued:
            if (
                not req.replayed
                and req.deadline_s is not None
                and now - req.t_enq > req.deadline_s
            ):
                if self._wal is not None and req.seq is not None:
                    self._wal.append(
                        wal.DROP, req.name,
                        drop_seq=req.seq, drop_cause="deadline-expired",
                    )
                self.stats["expired_requests"] += 1
                telemetry.emit(
                    "degrade", self.label, kind="admission",
                    cause="deadline-expired", session=req.name, seq=req.seq,
                    age_s=round(now - req.t_enq, 3),
                )
                self._finish_request(req, "expired", t_ret=now)
            else:
                live.append(req)
        return live

    def _coalesce(self, pending: List[_Request]) -> List[_Request]:
        """Concatenate same-session requests along the batch axis where the
        shapes allow it; anything else passes through untouched."""
        by_session: "OrderedDict[str, List[_Request]]" = OrderedDict()
        for req in pending:
            by_session.setdefault(req.name, []).append(req)
        out: List[_Request] = []
        for name, reqs in by_session.items():
            # a forward-value request's batch is its identity
            if len(reqs) > 1 and not any(r.ticket is not None for r in reqs):
                merged = self._try_concat(name, reqs)
                if merged is not None:
                    self.stats["coalesced_requests"] += len(reqs) - 1
                    out.append(merged)
                    continue
            out.extend(reqs)
        return out

    def _try_concat(self, name: str, reqs: List[_Request]) -> Optional[_Request]:
        flats, layouts = [], []
        for req in reqs:
            flat, layout = _flatten((req.args, req.kwargs))
            # every leaf a tensor batched on a shared dim 0, or the request cannot merge
            if not flat or any(not isinstance(x, Tensor) or x.ndim < 1 for x in flat):
                return None
            if len({int(x.shape[0]) for x in flat}) != 1:
                return None
            req.rows = int(flat[0].shape[0])
            flats.append(flat)
            layouts.append(layout)
        if any(layout != layouts[0] for layout in layouts[1:]):
            return None
        for leaves in zip(*flats):
            if any(
                x.shape[1:] != leaves[0].shape[1:] or x.dtype != leaves[0].dtype
                for x in leaves[1:]
            ):
                return None
        merged_flat = [torch.cat(list(leaves), dim=0) for leaves in zip(*flats)]
        args, kwargs = _unflatten(layouts[0], merged_flat)
        head = reqs[0]
        merged = _Request(
            name, args, kwargs, head.seq, head.rid,
            head.t_enq, head.t0, head.submit_tid,
            journal_us=head.journal_us, replayed=head.replayed,
        )
        merged.members = list(reqs)
        return merged

    # --------------------------------------------------------------- launch
    def _run_wave(self, entries: List[_Request]) -> None:
        """Group one wave by signature and launch each group."""
        from metrics_tpu_torch.metric import _is_static_scalar, _split_static_kwargs

        groups: "OrderedDict[Tuple, List]" = OrderedDict()
        for req in entries:
            args, kwargs = req.args, req.kwargs
            if any(_is_static_scalar(v) for v in args) or any(
                _is_static_scalar(v) for v in kwargs.values()
            ):
                args, kwargs = self.template._normalize_update_args(args, kwargs)
                static, dynamic = _split_static_kwargs(kwargs, numeric_static=False)
                static_key = tuple(sorted(static.items()))
            else:
                static, dynamic, static_key = {}, kwargs, ()
            try:
                flat, layout = _flatten((args, dynamic))
                if not flat or not all(isinstance(x, Tensor) and x.ndim >= 1 for x in flat):
                    raise ValueError("an input without a batch axis")
                batches = {int(x.shape[0]) for x in flat}
                if len(batches) != 1:
                    raise ValueError("non-uniform batch axis")
                batch = batches.pop()
                sig = (
                    static_key,
                    layout,
                    tuple((tuple(x.shape[1:]), x.dtype) for x in flat),
                    bucket_pow2(batch, minimum=_MIN_SESSION_BUCKET),
                    # forward-value requests build a program that also gives each lane's batch value
                    req.ticket is not None,
                )
                groups.setdefault(sig, []).append(
                    (req, args, dynamic, static, flat, batch)
                )
            except Exception:  # noqa: BLE001 - unstackable request shapes
                self._eager_entry(req, args, dynamic, static)
        for sig, group in groups.items():
            self._launch_group(sig, group)

    def _launch_group(self, sig: Tuple, group: List) -> None:
        static_key, layout, _, b_bucket, want_value = sig
        static = group[0][3]
        if not (self.template._masked_update_supported() and self._policy.allow()):
            for req, args, dynamic, static_kw, _, _ in group:
                self._eager_entry(req, args, dynamic, static_kw)
            return
        s_real = len(group)
        s_bucket = bucket_pow2(s_real, minimum=_MIN_SESSION_BUCKET)
        # pad lanes take index `capacity`: the scratch row
        idx = np.full((s_bucket,), self._capacity, dtype=np.int64)
        n_valid = np.zeros((s_bucket,), dtype=np.int32)
        lanes: List[List[Tensor]] = []
        for i, (req, _, _, _, flat, batch) in enumerate(group):
            idx[i] = self._rows[req.name]
            n_valid[i] = batch
            lanes.append(flat)
        example = lanes[0]
        in_avals = tuple(((s_bucket, b_bucket) + tuple(x.shape[1:]), x.dtype) for x in example)
        key = (
            "serve",
            static_key,
            layout,
            s_bucket,
            b_bucket,
            self._capacity,
            want_value,
            in_avals,
            tuple((tuple(self._stacked[k].shape), self._stacked[k].dtype) for k in self._names),
        )
        served = False
        try:
            program = self._exec_cache.get(key)
            if program is not None:
                self._exec_cache.move_to_end(key)
            else:
                program = self._compile_stacked(key, static, layout, in_avals, want_value=want_value)
            faults.check("launch", self.label)
            # the individually retiring requests, each with its masked-row count: its share of the launch's cost
            reqs: List[_Request] = []
            weights: List[int] = []
            for g_entry in group:
                g_req = g_entry[0]
                if g_req.members is None:
                    reqs.append(g_req)
                    weights.append(int(g_entry[5]))
                else:
                    for m in g_req.members:
                        reqs.append(m)
                        weights.append(m.rows)
            rids = [r.rid for r in reqs]
            t0 = telemetry.clock()
            l0 = time.monotonic()
            with telemetry.profiler_range(f"metrics_tpu.{self.label}.update[stacked-aot]"):
                vals, served = self._launch(program, key, idx, n_valid, lanes, b_bucket)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            l1 = time.monotonic()
            launch_us = (l1 - l0) * 1e6
            cost_entry = program.cost
            if billing.billing_enabled():
                # price the launch once, then split it over the member rids by masked rows (largest remainder):
                # the shares sum to the launch's cost exactly
                launch_micro = billing.cost_microusd(cost_entry)
                if launch_micro:
                    for r, share in zip(reqs, billing.apportion(launch_micro, weights)):
                        r.cost_microusd = share
            cost = cost_model.launch_attrs(cost_entry, launch_us) if telemetry.subscribed() else {}
            bill = billing.launch_cost_attrs(cost_entry) if telemetry.subscribed() else {}
            telemetry.emit(
                "update",
                self.label,
                "stacked-aot",
                t0=t0,
                stream="serve",
                sessions=s_real,
                session_bucket=s_bucket,
                bucket=b_bucket,
                static_key=static_key or None,
                rid_count=len(rids),
                rids=rids[:128],
                **cost,
                **bill,
            )
            launch_tid = threading.get_ident()
            for r in reqs:
                r.launch_us = launch_us
                r.t_launch_done = l1
                if t0 is not None:
                    # the flow anchor inside the update span on the flush lane
                    r.launch_ts_us = telemetry.stream_us(t0) + 1.0
                    r.launch_tid = launch_tid
            self._maybe_corrupt()
            if faults.any_active():
                # a corruption fault may have rewritten any row: every memo tag is suspect
                for r in range(self._capacity):
                    self._row_version[r] += 1
            else:
                for r in idx[:s_real]:
                    self._row_version[int(r)] += 1
            if vals is not None:
                for i, entry in enumerate(group):
                    g_req = entry[0]
                    if g_req.ticket is not None:
                        g_req.value = _lane_value(vals, i)
            self.stats["launches"] += 1
            if not self._policy.blocked:  # a failed capture benched the path, though the flush was served
                self._policy.note_success()
            if self._breakers:
                # a served request closes its session's circuit breaker
                for entry in group:
                    g_breaker = self._breakers.get(entry[0].name)
                    if g_breaker is not None:
                        g_breaker.note_success()
            self._inflight.append((event, reqs))
            while len(self._inflight) > self.max_inflight:
                self._retire(self._inflight.popleft())
        except Exception as err:  # noqa: BLE001 - degrade the group, keep serving
            if served:
                raise  # the state already holds this group's update: never apply it twice
            resilience.record_degrade(self.label, "serve", err, self._policy)  # benches the stacked path
            for req, args, dynamic, static_kw, _, _ in group:
                self._eager_entry(req, args, dynamic, static_kw)

    def _maybe_corrupt(self) -> None:
        """``state-corruption``: one stacked leaf replaced by a wrong-shape
        tensor, as the JAX package installs the corrupted launch output."""
        leaves = tuple(self._stacked[k] for k in self._names)
        out = faults.maybe_corrupt_leaves(leaves)
        if out is leaves:
            return
        for k, leaf in zip(self._names, out):
            if leaf is not self._stacked[k]:
                self._stacked[k] = self._phys[k] = leaf
        self._drop_programs()

    def _stacked_body(self, static: Dict, layout: Any, want_value: bool) -> Callable:
        """The stacked update as a function of its tensors: gather the lanes'
        rows (the scratch row for pad lanes), update each lane with its mask,
        scatter the rows back in place; returns the lanes' batch values
        (stacked) where asked for, else ``None``."""
        template, names = self.template, self._names
        default_rows = self._default_rows
        stacked_hook = getattr(template, "_stacked_masked_update", None)

        def body(phys: Dict[str, Tensor], idx: Tensor, n_valid: Tensor, flat: List[Tensor]) -> Any:
            s_bucket = idx.shape[0]
            rows = {k: phys[k].index_select(0, idx) for k in names}
            b_padded = flat[0].shape[1]
            mask = torch.arange(b_padded, dtype=torch.int32, device=idx.device)[None, :] < n_valid[:, None]
            args, dyn = _unflatten(layout, list(flat))
            new = None if stacked_hook is None else stacked_hook(rows, mask, *args, **dyn, **static)
            vals = None
            if new is not None:
                if want_value:
                    # forward semantics: a default state advanced by the lane's masked batch, then computed
                    fresh = {k: default_rows[k][None].expand_as(rows[k]) for k in names}
                    batch = stacked_hook(fresh, mask, *args, **dyn, **static)
                    vals = _stack_values([template.pure_compute({k: batch[k][i] for k in names})
                                          for i in range(s_bucket)])
            else:
                lanes_new, lanes_val = [], []
                for i in range(s_bucket):
                    lane_args, lane_dyn = _unflatten(layout, [x[i] for x in flat])
                    out = template._masked_pure_update({k: rows[k][i] for k in names}, mask[i], *lane_args,
                                                       **lane_dyn, **static)
                    lanes_new.append(out)
                    if want_value:
                        batch = template._masked_pure_update(dict(default_rows), mask[i], *lane_args, **lane_dyn,
                                                             **static)
                        lanes_val.append(template.pure_compute(batch))
                new = {k: torch.stack([lane[k] for lane in lanes_new]) for k in names}
                if want_value:
                    vals = _stack_values(lanes_val)
            for k in names:
                if not isinstance(new[k], Tensor) or new[k].shape != rows[k].shape or new[k].dtype != rows[k].dtype:
                    raise _StackedLayoutError(f"the stacked update changes the shape or dtype of state {k!r}")
            for k in names:
                phys[k].index_copy_(0, idx, new[k])
            return vals

        return body

    def _compile_stacked(self, key: Tuple, static: Dict, layout: Any, in_avals: Tuple, *,
                         want_value: bool = False) -> _StackedProgram:
        """A new program for ``key``. On the CPU it runs as it is each flush;
        on the card its first launch runs it once (serving that flush) and
        captures it into a CUDA graph (:meth:`_launch`)."""
        faults.check("compile", self.label)
        t0 = time.perf_counter()
        program = _StackedProgram(self._stacked_body(static, layout, want_value))
        s_bucket = key[3]
        row_bytes = sum(_nbytes(self._stacked[k][0]) for k in self._names) * s_bucket
        in_bytes = sum(int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size() for shape, dtype in in_avals)
        program.arg_bytes = in_bytes + s_bucket * (8 + 4) + row_bytes
        program.out_bytes = row_bytes
        cause = "first-compile" if not self._seen_signatures else "new-signature"
        self._seen_signatures.add(key)
        self.stats["retraces"] += 1
        self._cache_put(key, program)
        if self.device.type != "cuda":
            self._note_build(program, key, cause, t0)
        else:
            program.build = (cause, t0)  # the build's span waits for the capture: its cost entry needs it
        return program

    def _note_build(self, program: _StackedProgram, key: Tuple, cause: str, t0: float) -> None:
        program.cost = cost_model.record(self.label, "serve", key, program)
        telemetry.emit(
            "compile", self.label, "stacked-aot", t0=t0, stream="serve", cause=cause,
            **cost_model.compile_attrs(program.cost),
        )

    def _launch(self, program: _StackedProgram, key: Tuple, idx: np.ndarray, n_valid: np.ndarray,
                lanes: List[List[Tensor]], b_bucket: int) -> Tuple[Any, bool]:
        """Run one stacked launch: ``(the lanes' batch values, served)``.
        On the CPU the program runs as it is; on the card this copies the
        flush into the graph's static buffers and replays the graph, building
        the graph at the program's first launch."""
        dev = self.device
        if dev.type != "cuda":
            flat = self._stack_inputs(lanes, b_bucket, idx.shape[0])
            with tracing():
                vals = program.body(self._phys, torch.from_numpy(idx), torch.from_numpy(n_valid), flat)
            return vals, True
        if program.idx is None:
            return self._first_launch(program, key, idx, n_valid, lanes, b_bucket)
        self._stage(program, idx, n_valid, lanes)
        program.graph.replay()
        registry.note_replay(program.launched)
        return copy_tensors(program.values), True

    def _stack_inputs(self, lanes: List[List[Tensor]], b_bucket: int, s_bucket: int) -> List[Tensor]:
        """The lanes' inputs as ``(s_bucket, b_bucket, ...)`` tensors, zero-padded."""
        out = []
        for j, example in enumerate(lanes[0]):
            buf = example.new_zeros((s_bucket, b_bucket) + tuple(example.shape[1:]))
            for i, lane in enumerate(lanes):
                buf[i, : lane[j].shape[0]] = lane[j]
            out.append(buf)
        return out

    def _stage(self, program: _StackedProgram, idx: np.ndarray, n_valid: np.ndarray,
               lanes: List[List[Tensor]]) -> None:
        """Copy one flush into the graph's static buffers, without a host
        sync (pinned host memory, non-blocking). A lane's rows past its batch,
        and a pad lane's rows, keep what an earlier flush left there: the mask
        drops them."""
        dev = self.device
        program.idx.copy_(torch.from_numpy(idx).pin_memory(), non_blocking=True)
        program.n_valid.copy_(torch.from_numpy(n_valid).pin_memory(), non_blocking=True)
        s_real = len(lanes)
        b_bucket = program.inputs[0].shape[1]
        full = all(int(lane[0].shape[0]) == b_bucket for lane in lanes)  # a lane's inputs share their rows
        for j, buf in enumerate(program.inputs):
            parts = [lane[j] for lane in lanes]
            if full:
                torch.stack(parts, out=buf[:s_real])  # one kernel straight into the buffer
                continue
            # ragged lanes: one concatenation, scattered to each row's slot
            dest = np.concatenate([i * b_bucket + np.arange(int(p.shape[0]), dtype=np.int64)
                                   for i, p in enumerate(parts)])
            flat_buf = buf.view((-1,) + tuple(buf.shape[2:]))
            flat_buf.index_copy_(0, torch.from_numpy(dest).pin_memory().to(dev, non_blocking=True),
                                 torch.cat(parts))

    def _first_launch(self, program: _StackedProgram, key: Tuple, idx: np.ndarray, n_valid: np.ndarray,
                      lanes: List[List[Tensor]], b_bucket: int) -> Tuple[Any, bool]:
        """The program's first launch on the card: allocate its static
        buffers, run it once on a side stream (this serves the flush, and
        builds the kernels and warms the allocator outside the capture), then
        capture it into one CUDA graph. The capture runs nothing. It is made
        in thread-local mode, so that threads submitting meanwhile cannot
        invalidate it."""
        dev = self.device
        s_bucket = idx.shape[0]
        program.idx = torch.zeros((s_bucket,), dtype=torch.int64, device=dev)
        program.n_valid = torch.zeros((s_bucket,), dtype=torch.int32, device=dev)
        program.inputs = [x.new_zeros((s_bucket, b_bucket) + tuple(x.shape[1:])) for x in lanes[0]]
        self._stage(program, idx, n_valid, lanes)
        cause, t0 = program.build
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(dev)
        try:
            served_vals = warm_run(self._side_stream,
                                   lambda: program.body(self._phys, program.idx, program.n_valid, program.inputs))
        except Exception:
            program.idx = None  # nothing was served: the next launch of this program starts over
            raise
        allocated = torch.cuda.memory_stats(dev).get("allocated_bytes.all.current", 0)
        try:
            self._capture(program, lambda: program.body(self._phys, program.idx, program.n_valid, program.inputs))
        except Exception as err:  # noqa: BLE001 - the flush is served: the program goes, the stacked path is benched
            self._exec_cache.pop(key, None)
            resilience.record_degrade(self.label, "serve", err, self._policy)
        program.peak_temp_bytes = max(0, torch.cuda.memory_stats(dev).get("allocated_bytes.all.current", 0)
                                      - allocated)
        self._note_build(program, key, cause, t0)
        return served_vals, True

    def _capture(self, program: _StackedProgram, run: Callable[[], Any]) -> None:
        """Capture ``run`` into one CUDA graph of ``program`` (its outputs into
        ``program.values``, its kernel launches written down), in thread-local
        mode: another thread's CUDA call cannot invalidate it. The capture
        runs nothing."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        program.graph, program.values, program.launched = capture_graph(run, self._pool)

    def _cache_put(self, key: Tuple, program: _StackedProgram) -> None:
        self._exec_cache[key] = program
        self._exec_cache.move_to_end(key)
        limit = cache_max()
        while limit > 0 and len(self._exec_cache) > limit:
            self._exec_cache.popitem(last=False)
            self.stats["evictions"] += 1
            telemetry.emit("evict", self.label, "stacked-aot", stream="serve")

    def _eager_entry(self, req: _Request, args: Tuple, dynamic: Dict, static: Dict) -> None:
        """Per-request fallback: the template's own update on one row (exact
        semantics, no coalescing), for requests the stacked path cannot take
        or while the resilience policy holds it in cooldown. Also the
        per-session failure boundary: a request that fails even here is
        dropped with a cause-tagged ``degrade`` span and trips the session's
        circuit breaker."""
        name = req.name
        l0 = time.monotonic()
        try:
            row = self._rows[name]
            state = {k: self._stacked[k][row].clone() for k in self._names}
            new = self.template.pure_update(state, *args, **dynamic, **static)
            for k in self._names:
                if not isinstance(new[k], Tensor) or new[k].shape != state[k].shape:
                    raise _StackedLayoutError(f"the update changes the shape of state {k!r}")
            self._write_row(row, new)
            if req.ticket is not None:
                req.value = copy_tensors(self.template.pure_compute(
                    self.template.pure_update(dict(self._default_rows), *args, **dynamic, **static)
                ))
            self.stats["fallback_requests"] += 1
            breaker = self._breakers.get(name)
            if breaker is not None:
                breaker.note_success()
            t_ret = time.monotonic()
            for r in req.all():
                r.launch_us = (t_ret - l0) * 1e6
                r.t_launch_done = t_ret
                self._finish_request(r, "fallback", t_ret=t_ret)
        except Exception as err:  # noqa: BLE001 - isolate the poisoned request
            breaker = self._breakers.setdefault(name, resilience.ResiliencePolicy())
            resilience.record_degrade(  # trips the breaker
                self.label, "session", err, breaker, session=name
            )
            self.stats["failed_requests"] += 1
            t_ret = time.monotonic()
            for r in req.all():
                self._finish_request(r, "failed", t_ret=t_ret)

    # ------------------------------------------------------ flight recorder
    def _slo_record(
        self,
        name: str,
        outcome: str,
        e2e_us: Optional[float] = None,
        queue_us: Optional[float] = None,
        cost_microusd: Optional[int] = None,
    ) -> None:
        with self._slo_lock:
            slo = self._slo.get(name)
            if slo is None:
                slo = self._slo[name] = _SessionSLO()
            slo.record(outcome, e2e_us, queue_us, cost_microusd)

    def _finish_request(
        self, req: _Request, outcome: str, t_ret: Optional[float] = None
    ) -> None:
        """Close one request's flight record: its latency into the session's
        SLO sketches (always on) and, while instrumented, its ``request``
        span on the submitting thread's lane. Replayed requests emit spans
        tagged ``replayed=True`` and never touch the SLOs."""
        t_ret = time.monotonic() if t_ret is None else t_ret
        if req.ticket is not None:
            if outcome in ("served", "fallback"):
                req.ticket._resolve(req.value)
            else:
                req.ticket._reject(RuntimeError(
                    f"request rid={req.rid} for session {req.name!r} was "
                    f"{outcome} before serving; no batch value exists"
                ))
        e2e_us = max(0.0, (t_ret - req.t_enq) * 1e6)
        retire_us = 0.0
        if req.t_launch_done is not None:
            retire_us = max(0.0, (t_ret - req.t_launch_done) * 1e6)
        if not req.replayed:
            latencied = outcome in ("served", "fallback")
            billed = latencied and billing.billing_enabled()
            if billed:
                self.stats["cost_microusd"] += req.cost_microusd
                self.stats["billed_requests"] += 1
                guard = self._budgets.get(req.name)
                if guard is not None:
                    guard.charge(req.cost_microusd)
            self._slo_record(
                req.name, outcome,
                e2e_us if latencied else None,
                req.queue_us if latencied or outcome == "expired" else None,
                req.cost_microusd if billed else None,
            )
        if req.t0 is not None and telemetry.clock() is not None:
            extra: Dict[str, Any] = {"replayed": True} if req.replayed else {}
            if billing.billing_enabled():
                extra["cost_microusd"] = req.cost_microusd
                extra["cost_usd"] = billing.usd(req.cost_microusd)
            if self.shard_id is not None:
                extra["shard"] = self.shard_id
            if req.launch_ts_us is not None:
                extra["launch_ts_us"] = round(req.launch_ts_us, 3)
                extra["launch_tid"] = req.launch_tid
            telemetry.emit(
                "request", self.label, outcome,
                t0=req.t0, tid=req.submit_tid, stream="serve",
                rid=req.rid, session=req.name, seq=req.seq,
                queue_us=round(req.queue_us, 1),
                journal_us=round(req.journal_us, 1),
                launch_us=round(req.launch_us, 1),
                retire_us=round(retire_us, 1),
                retire_ts_us=round(telemetry.stream_us(time.perf_counter()), 3),
                **extra,
            )

    def _emit_gauges(self) -> None:
        """One health and one memory ``gauge`` a flush, built only while a
        session listens."""
        if telemetry.clock() is None:
            return
        h = self.health()
        telemetry.emit(
            "gauge", self.label, "health", stream="serve",
            queue_depth=h["queue_depth"], inflight=h["inflight"],
            sessions=h["sessions"], free_rows=h["free_rows"],
            open_breakers=sum(1 for b in h["breakers"].values() if b["open"]),
        )
        mem = self.memory_snapshot(top_n=3)
        telemetry.emit(
            "gauge", self.label, "memory", stream="serve",
            total_bytes=mem["total_bytes"], leaf_count=mem["leaf_count"],
            top=[[leaf["name"], leaf["nbytes"]] for leaf in mem["leaves"]],
        )

    def health(self) -> Dict[str, Any]:
        """Live gauges: queue depth, inflight generations, row occupancy,
        admission posture and each breaker's state (read without using up a
        cooldown)."""
        with self._queue_cond:
            queue_depth = len(self._queue)
        out = {
            "queue_depth": queue_depth,
            "inflight": len(self._inflight),
            "sessions": self.session_count,
            "capacity": self._capacity,
            "free_rows": len(self._free),
            "queue_bound": self.max_queue,
            "admission": self.admission,
            "breakers": {
                name: {
                    "open": bool(b.blocked),
                    "failures": int(b.failures),
                    "cooldown": int(b.cooldown),
                }
                for name, b in self._breakers.items()
            },
        }
        if billing.billing_enabled():
            out["cost"] = {
                **billing.rate_snapshot(),
                "cost_microusd": self.stats["cost_microusd"],
                "cost_usd": billing.usd(self.stats["cost_microusd"]),
                "billed_requests": self.stats["billed_requests"],
                "budgets": {
                    name: g.snapshot() for name, g in self._budgets.items()
                },
            }
        return out

    def slo_snapshot(self) -> Dict[str, Any]:
        """Per-tenant SLOs: end-to-end and queue-wait p50/p95/p99 (host
        sketches, relative error 0.05) and outcome counts a session, plus the
        cross-tenant ``"totals"`` (the sketches' lossless merge)."""
        from metrics_tpu_torch.streaming.sketch import HostQuantileSketch

        e2e = HostQuantileSketch(bins=512, alpha=0.05)
        qws = HostQuantileSketch(bins=512, alpha=0.05)
        totals: Dict[str, Any] = {k: 0 for k in _SessionSLO._OUTCOMES}
        cost_micro = billed = 0
        with self._slo_lock:
            sessions = {name: slo.snapshot() for name, slo in self._slo.items()}
            for slo in self._slo.values():
                for k in _SessionSLO._OUTCOMES:
                    totals[k] += slo.counts.get(k, 0)
                e2e.merge(slo.e2e_us)
                qws.merge(slo.queue_us)
                cost_micro += slo.cost_microusd
                billed += slo.billed
        totals["e2e_us"] = e2e.snapshot()
        totals["queue_us"] = qws.snapshot()
        if billing.billing_enabled():
            totals["cost_microusd"] = cost_micro
            totals["cost_usd"] = billing.usd(cost_micro)
            totals["usd_per_million_updates"] = (
                round(cost_micro / billed, 4) if billed else 0.0
            )
        return {"sessions": sessions, "totals": totals}

    def memory_snapshot(self, top_n: int = 10) -> Dict[str, Any]:
        """Per-leaf byte attribution of the stacked state: ``leaves`` the
        ``top_n`` largest, ``total_bytes`` over all of them (the scratch row
        is not session state and is not counted)."""
        leaves = [
            {
                "name": k,
                "shape": tuple(int(d) for d in self._stacked[k].shape),
                "dtype": dtype_name(self._stacked[k].dtype),
                "nbytes": _nbytes(self._stacked[k]),
                "logical_nbytes": _nbytes(self._stacked[k]),
            }
            for k in self._names
        ]
        total = sum(leaf["nbytes"] for leaf in leaves)
        leaves.sort(key=lambda leaf: (-leaf["nbytes"], leaf["name"]))
        return {
            "total_bytes": total,
            "logical_bytes": total,
            "leaf_count": len(leaves),
            "per_session_bytes": total // max(1, self._capacity),
            "leaves": leaves[: max(0, int(top_n))],
        }

    # -------------------------------------------------------------- results
    def _check_read_epoch(self) -> None:
        """Zombie fence for memoised reads: raises
        :class:`~metrics_tpu_torch.wal.StaleEpochError` when the journal
        directory was fenced above this service's epoch."""
        if self._wal is not None:
            self._wal.check_epoch()

    def _memo_get(self, name: str, row: int) -> Tuple[int, Optional[Any]]:
        """(current row version, memoised value or None); never a memo while
        a fault is armed."""
        ver = self._row_version[row]
        memo = self._memo.get(name)
        if (
            memo is not None
            and memo[0] == ver
            and memo[1] == self.epoch
            and not faults.any_active()
        ):
            return ver, memo[2]
        return ver, None

    def compute(self, name: str, *, _flushed: bool = False) -> Any:
        """Flush pending work, then evaluate one session's metric value. An
        un-ticked session serves its memoised value with no launch."""
        if not _flushed:
            self.flush()
        with self._flush_lock:
            row = self._rows.get(name)
            if row is None:
                raise KeyError(f"unknown session {name!r}")
            ver, hit = self._memo_get(name, row)
            if hit is not None:
                self._check_read_epoch()
                self.stats["read_memo_hits"] += 1
                telemetry.emit("read", self.label, "memo-hit", stream="serve", sessions=1)
                return hit
            # the rows are views of buffers a later launch writes: the value holds copies
            with tracing():
                value = copy_tensors(self.template.pure_compute({k: self._stacked[k][row] for k in self._names}))
            self.stats["read_memo_misses"] += 1
            telemetry.emit("read", self.label, "memo-miss", stream="serve", sessions=1)
            if not faults.any_active():
                self._memo[name] = (ver, self.epoch, value)
            return value

    def _read_plan(self) -> Tuple[List[str], Dict[str, Any], List[Tuple[str, int, int]]]:
        """The open sessions split into memo-served and dirty, the dirty ones
        with their version at plan time."""
        names_sorted = sorted(self._rows)
        memoized: Dict[str, Any] = {}
        dirty: List[Tuple[str, int, int]] = []
        for n in names_sorted:
            row = self._rows[n]
            ver, hit = self._memo_get(n, row)
            if hit is not None:
                memoized[n] = hit
            else:
                dirty.append((n, row, ver))
        return names_sorted, memoized, dirty

    def _compute_rows(self, idx: np.ndarray) -> Any:
        """Every lane's value of ``compute`` for the rows ``idx`` (pad lanes:
        the scratch row), stacked: one program, on the card one CUDA graph a
        bucket of lanes."""
        template, names = self.template, self._names

        def body(phys: Dict[str, Tensor], idx_t: Tensor) -> Any:
            rows = {k: phys[k].index_select(0, idx_t) for k in names}
            return _stack_values([template.pure_compute({k: rows[k][i] for k in names})
                                  for i in range(idx_t.shape[0])])

        if self.device.type != "cuda":
            with tracing():
                return body(self._phys, torch.from_numpy(idx))
        m = idx.shape[0]
        program = self._compute_stack.get(m)
        if program is None:
            program = self._compute_stack[m] = _StackedProgram(body)
            program.idx = torch.from_numpy(idx).to(self.device)
            with tracing():
                warm = copy_tensors(body(self._phys, program.idx))
            self._capture(program, lambda: body(self._phys, program.idx))
            return warm
        program.idx.copy_(torch.from_numpy(idx).pin_memory(), non_blocking=True)
        program.graph.replay()
        registry.note_replay(program.launched)
        return copy_tensors(program.values)

    def compute_all(self) -> Dict[str, Any]:
        """Flush, then evaluate every open session: memo-clean sessions are
        served host-side, only the dirty rows ride one program (the row
        index padded to a pow2 bucket, so a dirty count builds nothing new).
        Per-session fallback where the program fails."""
        self.flush()
        with self._flush_lock:
            if not self._rows:
                return {}
            t0 = telemetry.clock()
            names_sorted, memoized, dirty = self._read_plan()
            if memoized:
                self._check_read_epoch()
            self.stats["read_memo_hits"] += len(memoized)
            self.stats["read_memo_misses"] += len(dirty)
            if not dirty:
                telemetry.emit(
                    "read", self.label, "memo-hit", t0=t0, stream="serve",
                    sessions=len(names_sorted), dirty=0, memoized=len(memoized),
                )
                return {n: memoized[n] for n in names_sorted}
            chaos = faults.any_active()
            try:
                m = bucket_pow2(len(dirty), minimum=_MIN_SESSION_BUCKET)
                idx = np.full((m,), self._capacity, dtype=np.int64)
                for i, (_, row, _) in enumerate(dirty):
                    idx[i] = row
                stacked_vals = self._compute_rows(idx)
                out = dict(memoized)
                for i, (n, _row, ver) in enumerate(dirty):
                    val = _lane_value(stacked_vals, i)
                    out[n] = val
                    if not chaos:
                        self._memo[n] = (ver, self.epoch, val)
                telemetry.emit(
                    "read", self.label, "batch", t0=t0, stream="serve",
                    sessions=len(names_sorted), dirty=len(dirty),
                    memoized=len(memoized),
                )
                return {n: out[n] for n in names_sorted}
            except Exception as err:  # noqa: BLE001 - e.g. a value-dependent compute
                resilience.record_degrade(self.label, "compute", err)
                self._compute_stack = {}
                out = dict(memoized)
                for n, _row, _ver in dirty:
                    out[n] = self.compute(n, _flushed=True)
                return {n: out[n] for n in names_sorted}

    def compute_window(self, name: Optional[str] = None) -> Any:
        """Windowed read of a streaming-window service (``TypeError`` for
        any other template): one session with ``name``, else every open one.
        Emits a ``window`` span (kind ``serve-compute``)."""
        from metrics_tpu_torch.streaming.window import _StreamingWindow

        if not isinstance(self.template, _StreamingWindow):
            raise TypeError(
                f"compute_window() needs a streaming window template "
                f"(SlidingWindow/TumblingWindow/ExponentialDecay), got "
                f"{type(self.template).__name__}; use compute()/compute_all() "
                f"for lifetime values"
            )
        t0 = telemetry.clock()
        out = self.compute(name) if name is not None else self.compute_all()
        telemetry.emit(
            "window",
            type(self.template).__name__,
            "serve-compute",
            t0=t0,
            sessions=1 if name is not None else len(self._rows),
        )
        return out

    # ----------------------------------------------------------- checkpoint
    def _checkpoint_path(self, path: Optional[str]) -> str:
        if path is not None:
            return path
        if self.checkpoint_dir is None:
            raise ValueError("no checkpoint path given and no checkpoint_dir configured")
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        return os.path.join(self.checkpoint_dir, "metrics_service.ckpt.npz")

    def checkpoint(self, path: Optional[str] = None) -> str:
        """Write every session's state in one pass (the stacked leaves and
        the session table, crc32-checksummed, renamed into place); returns
        the path. With a journal, the meta holds its high-water sequence
        (``journal_seq``), the exactly-once fence, and fully retired
        segments are truncated after the rename."""
        path = self._checkpoint_path(path)
        if self._wal is not None:
            self._wal.check_epoch()
        with self._flush_lock:
            # drain until the queue stays empty: the fence covers exactly the applied records
            while True:
                self.drain()
                with self._queue_cond:
                    if not self._queue:
                        fence = self._wal.last_seq if self._wal is not None else 0
                        break
            meta = json.dumps(
                {
                    "rows": self._rows,
                    "capacity": self._capacity,
                    "template": type(self.template).__name__,
                    "template_attrs": self._portable_template_attrs(),
                    "journal_seq": fence,
                    "epoch": self.epoch,
                    "closed": sorted(self._closed),
                    "ts": round(time.time(), 6),
                }
            )
            payload: Dict[str, Any] = {
                f"state::{k}": self._stacked[k].cpu().numpy() for k in self._names
            }
            payload["__meta__"] = np.frombuffer(meta.encode(), dtype=np.uint8)
            payload = attach_checksums(payload)
            t0 = telemetry.clock()
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                np.savez(f, **payload)
            faults.crash_point("mid-checkpoint", self.label)
            os.replace(tmp, path)
            telemetry.emit(
                "checkpoint", self.label, "serve", t0=t0, stream="serve",
                sessions=len(self._rows), path=os.path.basename(path),
                journal_seq=fence,
            )
            self.stats["checkpoints"] += 1
            if self.history is not None:
                # the rung and the floor before the truncation: a retained rung keeps its replay tail
                self._retain_rung(path, fence)
            if self._wal is not None:
                self._wal.truncate(fence)
        return path

    # ----------------------------------------------------- checkpoint ladder
    @staticmethod
    def _rung_path(path: str, fence: int) -> str:
        return f"{path}.rung-{fence:020d}"

    def _ladder_rungs(self, path: Optional[str] = None) -> List[Tuple[int, str]]:
        """Retained (not quarantined) rungs as ``(fence, path)``, by fence;
        empty without a checkpoint tier."""
        try:
            path = self._checkpoint_path(path)
        except ValueError:
            return []
        directory = os.path.dirname(path) or "."
        prefix = os.path.basename(path) + ".rung-"
        try:
            names = os.listdir(directory)
        except FileNotFoundError:
            return []
        rungs: List[Tuple[int, str]] = []
        for n in names:
            if not n.startswith(prefix) or n.endswith(".quarantine"):
                continue
            try:
                fence = int(n[len(prefix):])
            except ValueError:
                continue
            rungs.append((fence, os.path.join(directory, n)))
        rungs.sort()
        return rungs

    @staticmethod
    def _rung_meta(rung_path: str) -> Dict[str, Any]:
        """One rung's ``__meta__`` (``StateCorruptionError`` on anything
        unreadable or damaged)."""
        try:
            with np.load(rung_path) as data:
                payload = {k: data[k] for k in data.files}
        except Exception as err:  # noqa: BLE001 - torn write, not-a-zip, ...
            raise resilience.StateCorruptionError(
                f"ladder rung {rung_path!r} is unreadable: {err}"
            ) from err
        verify_checksums(payload)
        try:
            return json.loads(bytes(payload["__meta__"]).decode())
        except Exception as err:  # noqa: BLE001 - missing/garbled meta entry
            raise resilience.StateCorruptionError(
                f"ladder rung {rung_path!r} has a missing or garbled __meta__: {err}"
            ) from err

    def _pin_history_floor(self, path: Optional[str] = None) -> None:
        """Pin the journal's ladder floor to the oldest retained rung's fence."""
        if self._wal is None:
            return
        rungs = self._ladder_rungs(path)
        self._wal.history_floor = rungs[0][0] if rungs else None

    def _retain_rung(self, path: str, fence: int) -> None:
        """Land the checkpoint just written as a rung, apply the retention
        policy, and re-pin the journal floor."""
        rung = self._rung_path(path, fence)
        # the fault targets the rung alone, so it gets its own inode: a hard link would rot the head with it
        corrupt = faults.should_fire("history-corruption")
        if not os.path.exists(rung):
            if corrupt:
                shutil.copyfile(path, rung)
            else:
                try:
                    os.link(path, rung)
                except OSError:
                    shutil.copyfile(path, rung)
        if corrupt:
            self._corrupt_rung_file(rung)
        self._history_gc(path)
        self._pin_history_floor(path)

    @staticmethod
    def _corrupt_rung_file(rung: str) -> None:
        """At-rest bit rot, deterministic: four bytes flipped at the middle."""
        try:
            with open(rung, "r+b") as f:
                f.seek(max(0, os.path.getsize(rung) // 2))
                chunk = f.read(4)
                f.seek(-len(chunk), os.SEEK_CUR)
                f.write(bytes(b ^ 0xFF for b in chunk))
        except OSError:
            pass  # the fault is best-effort; a vanished rung is its own fault

    def _history_gc(self, path: str) -> None:
        """Keep the newest ``keep_last`` rungs, and among older ones the
        newest of each ``keep_per_interval_s`` interval; unlink the rest
        behind the ``mid-history-gc`` crash point (a kill mid-GC leaves extra
        rungs, never a missing tail)."""
        pol = self.history
        assert pol is not None
        rungs = self._ladder_rungs(path)
        if len(rungs) <= pol.keep_last:
            return
        newest_first = list(reversed(rungs))
        keep = {fence for fence, _ in newest_first[: pol.keep_last]}
        if pol.keep_per_interval_s is not None:
            seen_buckets: set = set()
            for fence, rp in newest_first[pol.keep_last:]:
                try:
                    ts = self._rung_meta(rp).get("ts")
                except resilience.StateCorruptionError:
                    keep.add(fence)  # a damaged rung is scrub's to quarantine, not GC's to delete
                    continue
                bucket = None if ts is None else int(float(ts) // pol.keep_per_interval_s)
                if bucket not in seen_buckets:
                    seen_buckets.add(bucket)
                    keep.add(fence)
        removed = 0
        for fence, rp in rungs:
            if fence in keep:
                continue
            faults.crash_point("mid-history-gc", self.label)
            try:
                os.remove(rp)
            except FileNotFoundError:
                pass  # an earlier, interrupted GC removed it
            removed += 1
        if removed:
            self.stats["history_rungs_gcd"] = self.stats.get("history_rungs_gcd", 0) + removed
            telemetry.emit(
                "checkpoint", self.label, "history-gc", stream="serve",
                removed=removed, retained=len(rungs) - removed,
            )

    def restore(
        self,
        path: Optional[str] = None,
        *,
        missing_ok: bool = False,
        replay: bool = True,
    ) -> bool:
        """Install a checkpoint written by :meth:`checkpoint` (by either
        package), then replay the journal tail above its fence. Returns
        ``True`` when a checkpoint was installed. A missing checkpoint raises
        :class:`~metrics_tpu_torch.resilience.StateCorruptionError` unless
        ``missing_ok=True`` (first boot: the journal replays from sequence
        0); a truncated or unreadable one always raises it."""
        if missing_ok:
            # first boot on an empty volume: (re)create the directory chain
            if self.journal_dir is not None:
                os.makedirs(self.journal_dir, exist_ok=True)
            if self.checkpoint_dir is not None:
                os.makedirs(self.checkpoint_dir, exist_ok=True)
        if path is None and self.checkpoint_dir is None and missing_ok:
            if replay and self._wal is not None:
                self._replay_journal(0)
            return False
        path = self._checkpoint_path(path)
        if not os.path.exists(path):
            if not missing_ok:
                raise resilience.StateCorruptionError(
                    f"checkpoint {path!r} does not exist; pass missing_ok=True "
                    "if this is a first boot (the journal tail, if any, still replays)"
                )
            if replay and self._wal is not None:
                self._replay_journal(0)
            return False
        try:
            with np.load(path) as data:
                payload = {k: data[k] for k in data.files}
        except Exception as err:  # noqa: BLE001 - torn write, not-a-zip, ...
            raise resilience.StateCorruptionError(
                f"checkpoint {path!r} is unreadable (truncated or corrupt): {err}"
            ) from err
        verify_checksums(payload)
        payload = {k: v for k, v in payload.items() if not str(k).startswith(CHECKSUM_PREFIX)}
        try:
            meta = json.loads(bytes(payload.pop("__meta__")).decode())
        except Exception as err:  # noqa: BLE001 - missing/garbled meta entry
            raise resilience.StateCorruptionError(
                f"checkpoint {path!r} has a missing or garbled __meta__ entry: {err}"
            ) from err
        if meta["template"] != type(self.template).__name__:
            raise resilience.StateCorruptionError(
                f"checkpoint holds {meta['template']} state, service template is "
                f"{type(self.template).__name__}"
            )
        with self._flush_lock:
            self._capacity = int(meta["capacity"])
            self._install_template_attrs(meta.get("template_attrs", {}))
            self._alloc_rows(self._capacity, rows={k: payload[f"state::{k}"] for k in self._names})
            self._rows = {str(n): int(r) for n, r in meta["rows"].items()}
            used = set(self._rows.values())
            self._free = [r for r in range(self._capacity - 1, -1, -1) if r not in used]
            self._closed = set(meta.get("closed", []))
            self._drop_programs()
            # the installed state is new: every memo tag predates it
            self._row_version = [0] * self._capacity
            self._memo.clear()
        fence = int(meta.get("journal_seq", 0))
        if self._wal is not None:
            # a journal whose segments were all truncated must never re-issue fenced sequence numbers
            self._wal.ensure_seq(fence)
            if replay:
                self._replay_journal(fence)
        if self.history is not None:
            # a restored process inherits the ladder on disk: the floor is pinned before any truncation
            self._pin_history_floor()
        return True

    def recover(self, path: Optional[str] = None) -> bool:
        """Crash recovery: :meth:`restore` tolerating a missing checkpoint
        (first boot) and always replaying the journal tail. Returns ``True``
        when a checkpoint was installed.

        With a ladder (``history=``) a corrupt newest checkpoint does not end
        recovery: it is quarantined (renamed, never deleted) with a
        ``degrade`` span of kind ``history``, and recovery falls back to the
        newest rung that verifies, replaying its longer journal tail."""
        try:
            return self.restore(path, missing_ok=True, replay=True)
        except resilience.StateCorruptionError as err:
            if self.history is None:
                raise
            bad = self._checkpoint_path(path)
            if os.path.exists(bad):
                os.replace(bad, bad + ".quarantine")
            resilience.record_degrade(self.label, "history", err, stage="recover")
            self.stats["quarantined_rungs"] = self.stats.get("quarantined_rungs", 0) + 1
        for fence, rp in reversed(self._ladder_rungs(path)):
            try:
                return self.restore(rp, missing_ok=False, replay=True)
            except resilience.StateCorruptionError as err:
                os.replace(rp, rp + ".quarantine")
                resilience.record_degrade(self.label, "history", err, stage="recover", rung=fence)
                self.stats["quarantined_rungs"] = self.stats.get("quarantined_rungs", 0) + 1
        # every rung failed: the journal alone (its floor kept the whole tail)
        if self._wal is not None:
            self._replay_journal(0)
        return False

    def _replay_journal(self, fence: int) -> int:
        """Apply the journal tail above ``fence`` in sequence order through
        the normal flush machinery."""
        assert self._wal is not None
        records = self._wal.read_tail(fence)
        if not records:
            return 0
        t0 = telemetry.clock()
        self.apply_records(records)
        telemetry.emit(
            "journal", self.label, "replay", t0=t0, stream="serve",
            records=len(records), fence=fence,
        )
        return len(records)

    def apply_records(self, records: List[wal.WalRecord]) -> int:
        """Apply resolved journal records in sequence order through the
        normal flush machinery (journal replay, and a standby's shipped
        records). Updates queue and flush in batches; close and reset records
        are ordering barriers. Applied work is never re-journaled, never
        expires and never triggers a periodic checkpoint."""
        self._replaying = True
        try:
            for rec in records:
                if rec.kind == wal.UPDATE:
                    # the journaled rid is reused, and the mint counter moves past it
                    self.open_session(rec.session)
                    with self._queue_cond:
                        if rec.rid > self._rid:
                            self._rid = rec.rid
                        self._queue.append(_Request(
                            rec.session, self._to_device(tuple(rec.args)), self._to_device(dict(rec.kwargs)),
                            rec.seq, rec.rid, time.monotonic(), telemetry.clock(),
                            threading.get_ident(), replayed=True,
                        ))
                elif rec.kind == wal.CLOSE:
                    self.flush()
                    self.close_session(rec.session)
                elif rec.kind == wal.RESET:
                    self.flush()
                    self.reset_session(rec.session)
            self.drain()
        finally:
            self._replaying = False
        self.stats["replayed_records"] += len(records)
        return len(records)

    # ------------------------------------------------------- time travel
    def _boundary_seq(self, t: float, records: List[wal.WalRecord]) -> int:
        """The sequence fence a wall-clock boundary ``t`` resolves to: the
        highest seq whose record has ``ts <= t`` (a record without ``ts``
        never moves it). Clocks skew (``clock-skew``), so ``t`` only picks a
        fence: replay is then by seq, every record at or below it."""
        fence = (self._wal.first_seq() - 1) if self._wal is not None else 0
        for rec in records:
            if rec.ts is not None and rec.ts <= t:
                fence = max(fence, rec.seq)
        return fence

    def _scratch(self) -> "MetricsService":
        # a journal-less service on a copy of the template: a pure update loads states into its template
        return MetricsService(copy.deepcopy(self.template))

    def service_at(self, t: float) -> Tuple["MetricsService", int]:
        """This service's state as of wall-clock ``t``, rebuilt in a
        journal-less scratch service (live rows are never touched): returns
        ``(scratch, fence)``. The newest readable rung at or below the fence,
        then the journal records between the rung's fence and this one,
        through the scratch's flush machinery. A rung that fails verification
        is skipped with a ``degrade`` span of kind ``history`` (a read never
        changes the ladder: quarantine is :meth:`scrub`'s), and the next
        older rung carries the longer replay."""
        records = self._wal.read_tail(0) if self._wal is not None else []
        fence = self._boundary_seq(t, records)
        scratch = self._scratch()
        base_fence = 0
        for rung_fence, rp in reversed(self._ladder_rungs()):
            if rung_fence > fence:
                continue
            try:
                scratch.restore(rp, missing_ok=False, replay=False)
                base_fence = rung_fence
                break
            except resilience.StateCorruptionError as err:
                resilience.record_degrade(self.label, "history", err, stage="read", rung=rung_fence)
        scratch.apply_records([r for r in records if base_fence < r.seq <= fence])
        return scratch, fence

    def compute_at(self, t: float, name: Optional[str] = None) -> Any:
        """Point-in-time read: the value of session ``name`` (else of every
        session open at ``t``) as of wall-clock ``t``, from the ladder and the
        fenced journal replay (:meth:`service_at`). Emits a ``read`` span of
        kind ``time-travel``."""
        t0 = telemetry.clock()
        scratch, fence = self.service_at(t)
        try:
            out = scratch.compute(name) if name is not None else scratch.compute_all()
        finally:
            scratch.shutdown()
        self.stats["time_travel_reads"] = self.stats.get("time_travel_reads", 0) + 1
        telemetry.emit(
            "read", self.label, "time-travel", t0=t0, stream="serve",
            fence=fence, sessions=1 if name is not None else scratch.session_count,
        )
        return out

    def compute_range(self, t1: float, t2: float, name: Optional[str] = None) -> Any:
        """Range read: the value(s) over the updates whose journal ``ts``
        lies in ``(t1, t2]``, replayed by seq into a fresh scratch service
        (records without ``ts`` are left out). Emits a ``read`` span of kind
        ``time-travel``."""
        if t2 < t1:
            raise ValueError(f"compute_range wants t1 <= t2, got ({t1}, {t2})")
        t0 = telemetry.clock()
        records = self._wal.read_tail(0) if self._wal is not None else []
        picked = [r for r in records if r.ts is not None and t1 < r.ts <= t2]
        scratch = self._scratch()
        try:
            scratch.apply_records(picked)
            out = scratch.compute(name) if name is not None else scratch.compute_all()
            sessions = 1 if name is not None else scratch.session_count
        finally:
            scratch.shutdown()
        self.stats["time_travel_reads"] = self.stats.get("time_travel_reads", 0) + 1
        telemetry.emit(
            "read", self.label, "time-travel", t0=t0, stream="serve",
            records=len(picked), sessions=sessions,
        )
        return out

    def scrub(self, path: Optional[str] = None, *, quarantine: bool = True) -> Dict[str, Any]:
        """Verify every ladder rung and the live checkpoint end to end (the
        archive's crc and meta, the template, and a journal tail that starts
        right above the rung's fence and decodes). A rung that fails is
        quarantined (renamed ``*.quarantine``, never deleted) with a
        ``degrade`` span of kind ``history``; ``quarantine=False`` only
        reports. Re-pins the journal floor; returns ``{"checked",
        "verified", "quarantined", "newest_verified"}``."""
        candidates: List[Tuple[Optional[int], str]] = list(self._ladder_rungs(path))
        try:
            head: Optional[str] = self._checkpoint_path(path)
        except ValueError:
            head = None
        if head is not None and os.path.exists(head):
            candidates.append((None, head))
        verified: List[int] = []
        bad: List[str] = []
        for fence, rp in candidates:
            err: Optional[Exception] = None
            try:
                meta = self._rung_meta(rp)
                if meta["template"] != type(self.template).__name__:
                    raise resilience.StateCorruptionError(
                        f"rung {rp!r} holds {meta['template']} state, service "
                        f"template is {type(self.template).__name__}"
                    )
                rung_fence = int(meta.get("journal_seq", 0))
                if fence is not None and rung_fence != fence:
                    raise resilience.StateCorruptionError(
                        f"rung {rp!r} names fence {fence} but its meta says {rung_fence}"
                    )
                if self._wal is not None:
                    if self._wal.first_seq() > rung_fence + 1:
                        raise resilience.StateCorruptionError(
                            f"rung {rp!r} (fence {rung_fence}) lost its replay "
                            f"tail: journal starts at {self._wal.first_seq()}"
                        )
                    self._wal.read_tail(rung_fence)  # the tail decodes (frame crcs)
            except resilience.StateCorruptionError as caught:
                err = caught
            if err is None:
                verified.append(rung_fence)
                continue
            bad.append(rp)
            resilience.record_degrade(
                self.label, "history", err, stage="scrub", rung=os.path.basename(rp),
            )
            if quarantine:
                os.replace(rp, rp + ".quarantine")
                self.stats["quarantined_rungs"] = self.stats.get("quarantined_rungs", 0) + 1
        if self.history is not None:
            self._pin_history_floor(path)
        return {
            "checked": len(candidates),
            "verified": sorted(verified),
            "quarantined": bad,
            "newest_verified": max(verified) if verified else None,
        }

    # --------------------------------- elastic membership / replication
    def replication_floor(self) -> int:
        """Highest journal seq at or below which every record is resolved
        (applied, or durably dropped): the prefix a standby may apply."""
        if self._wal is None:
            return 0
        with self._flush_lock:
            with self._queue_cond:
                pending = [r.seq for r in self._queue if r.seq is not None]
                last = self._wal.last_seq
        return (min(pending) - 1) if pending else last

    def advance_epoch(self, epoch: int) -> int:
        """Re-claim this service's journal at a higher ownership epoch (a
        planned hand-off fence). No-op at or below the current epoch."""
        epoch = int(epoch)
        if epoch <= self.epoch:
            return self.epoch
        self.epoch = epoch
        if self._wal is not None:
            wal.fence_epoch(self._wal.directory, epoch)
            self._wal.epoch = epoch
        return epoch

    def attach_durability(
        self,
        journal_dir: Optional[str],
        checkpoint_dir: Optional[str],
        epoch: int,
    ) -> None:
        """Attach a shard's durable directories to a warm journal-less
        standby at promotion time; the journal opens at ``epoch``."""
        if self._wal is not None:
            self._wal.close()
        self._wal = None
        self.journal_dir = journal_dir
        self.checkpoint_dir = checkpoint_dir
        self.epoch = int(epoch)
        if journal_dir is not None and wal.wal_enabled():
            self._wal = wal.WriteAheadLog(
                journal_dir, owner=self.label, epoch=self.epoch
            )

    def rebase_rids(self, offset: int, stride: int) -> None:
        """Move this service's request-id lattice."""
        with self._queue_cond:
            self._rid = int(offset)
            self._rid_stride = max(1, int(stride))

    def _portable_template_attrs(self) -> Dict[str, Any]:
        # the template's scalar attributes (some metrics fix their config from their first inputs): the same
        # filter as the JAX package's, so that its checkpoint meta and this one carry the same keys
        return {
            k: v
            for k, v in vars(self.template).items()
            if not k.startswith("_")
            and k not in self._names
            and isinstance(v, (bool, int, float, str, type(None)))
        }

    def _install_template_attrs(self, attrs: Dict[str, Any]) -> None:
        for k, v in attrs.items():
            try:
                setattr(self.template, k, v)
            except Exception:  # noqa: BLE001 - read-only/derived attrs
                pass

    def export_sessions(self, names: List[str]) -> Dict[str, Any]:
        """Portable host copies of the named sessions' rows plus the
        template's scalar attributes (a planned hand-off)."""
        rows: Dict[str, Dict[str, np.ndarray]] = {}
        with self._flush_lock:
            for name in names:
                row = self._rows.get(name)
                if row is None:
                    raise KeyError(f"unknown session {name!r}; nothing to export")
                rows[name] = {
                    k: self._stacked[k][row].cpu().numpy() for k in self._names
                }
        return {"rows": rows, "template_attrs": self._portable_template_attrs()}

    def import_sessions(self, payload: Dict[str, Any]) -> int:
        """Install exported session rows (idempotent per session); returns
        how many landed."""
        with self._flush_lock:
            self._install_template_attrs(payload.get("template_attrs", {}))
            for name, leaves in payload["rows"].items():
                row = self.open_session(name)
                self._write_row(row, leaves)
                self._memo.pop(name, None)
            return len(payload["rows"])

    def mirror_state(self, src: "MetricsService", precision: Optional[str] = None) -> Optional[float]:
        """Install a bit-identical copy of another service's stacked state
        (standby seeding). With ``precision="int8"`` every leaf crosses as a
        crc-guarded seed frame (:func:`metrics_tpu_torch.wal.encode_seed_frame`):
        float leaves block-wise int8, the rest raw; returns the frame's error
        budget."""
        with self._flush_lock:
            self._capacity = src._capacity
            self._rows = dict(src._rows)
            used = set(self._rows.values())
            self._free = [
                r for r in range(self._capacity - 1, -1, -1) if r not in used
            ]
            self._closed = set(src._closed)
            with self._queue_cond:
                self._rid = src._rid
                self._rid_stride = src._rid_stride
            self._install_template_attrs(src._portable_template_attrs())
            budget = None
            rows: Dict[str, Any] = {k: src._stacked[k] for k in self._names}
            if precision is not None:
                frame = wal.encode_seed_frame(
                    rows, precision=precision, quantize_opt=getattr(src.template, "_quantize", None),
                )
                if faults.should_fire("quant-corruption"):
                    # the frame garbled in flight: its crc must turn this into StateCorruptionError
                    frame = frame[:-1] + bytes([frame[-1] ^ 0xFF])
                rows = wal.decode_seed_frame(frame)
                budget = wal.frame_error_budget(frame)
            self._alloc_rows(self._capacity, rows=rows)
            self._drop_programs()
            self._row_version = [0] * self._capacity
            self._memo.clear()
            return budget

    def state_digest(self, names: Optional[List[str]] = None) -> str:
        """sha1 over the named (default: every open) sessions' rows, in name
        order: the numpy bytes of each leaf's row, as the JAX package hashes
        them. Does not flush."""
        host = {k: self._stacked[k].cpu().numpy() for k in self._names}
        h = hashlib.sha1()
        for name in sorted(self._rows if names is None else names):
            row = self._rows.get(name)
            if row is None:
                continue
            h.update(name.encode())
            for k in self._names:
                h.update(host[k][row].tobytes())
        return h.hexdigest()

    # ---------------------------------------------------------------- stats
    @property
    def journal(self) -> Optional[wal.WriteAheadLog]:
        """The attached write-ahead journal (``None`` without ``journal_dir``
        or with ``METRICS_TPU_WAL=0``)."""
        return self._wal

    def telemetry_snapshot(self) -> Dict[str, Any]:
        """Service counters, resilience state, the journal's counters
        (``None`` without one), memory, health, the background scrubber's
        run and error counts with its latest report (``"history"``), and the
        JAX package's program-cache key (zeros here: not ported)."""
        from metrics_tpu_torch.metric import aot_cache_stats

        return {
            "owner": self.label,
            "shard": self.shard_id,
            "epoch": self.epoch,
            "serve": dict(self.stats),
            "sessions": self.session_count,
            "capacity": self._capacity,
            "resilience": self._policy.stats(),
            "aot_cache": aot_cache_stats(),
            "wal": self._wal.stats() if self._wal is not None else None,
            "memory": self.memory_snapshot(),
            "health": self.health(),
            "history": dict(self._scrub_stats),
        }


class ShardedCapacityService(MetricsService):
    """The stacked capacity axis placed across N local shards.

    ``MetricsService(template, shard_capacity=N)`` (or this class directly)
    builds ``N`` child services and routes every session to
    ``crc32(name) % N``: one handle holding N times the tenants of one stack
    at the same per-shard state bytes, one stacked launch per shard a
    flush. Each child updates a copy of the template (a pure update loads a
    state into it), on ``shard_devices[k]`` where given. Rid lattices
    interleave (shard k mints ``offset + k·s`` stepping ``N·s``).
    """

    def __init__(
        self,
        template: Any,
        *,
        shard_capacity: int,
        shard_devices: Optional[List[Any]] = None,
        checkpoint_dir: Optional[str] = None,
        journal_dir: Optional[str] = None,
        rid_offset: int = 0,
        rid_stride: int = 1,
        epoch: int = 0,
        **kwargs: Any,
    ) -> None:
        n = int(shard_capacity)
        if n < 2:
            raise ValueError(f"shard_capacity must be >= 2, got {n}")
        if shard_devices is not None and len(shard_devices) < n:
            raise ValueError(
                f"shard_devices has {len(shard_devices)} devices for {n} shards"
            )
        self.template = template
        self.n_shards = n
        self.shard_id = None
        self.epoch = int(epoch)
        self.label = f"ShardedCapacityService[{type(template).__name__}]x{n}"
        stride = max(1, int(rid_stride))
        self.shards: List[MetricsService] = []
        for k in range(n):
            child_template = copy.deepcopy(template)
            if shard_devices is not None:
                child_template = child_template.to(shard_devices[k])
            self.shards.append(MetricsService(
                child_template,
                checkpoint_dir=(
                    os.path.join(checkpoint_dir, f"shard{k}") if checkpoint_dir else None
                ),
                journal_dir=(
                    os.path.join(journal_dir, f"shard{k}") if journal_dir else None
                ),
                shard_id=k,
                rid_offset=int(rid_offset) + k * stride,
                rid_stride=stride * n,
                epoch=epoch,
                **kwargs,
            ))

    # ------------------------------------------------------------- routing
    def shard_of(self, name: str) -> int:
        """The stable shard index serving ``name`` (crc32 routing)."""
        return zlib.crc32(name.encode()) % self.n_shards

    def _child(self, name: str) -> MetricsService:
        return self.shards[self.shard_of(name)]

    # ------------------------------------------------------------- sessions
    @property
    def session_count(self) -> int:
        return sum(c.session_count for c in self.shards)

    def open_session(self, name: str) -> int:
        return self._child(name).open_session(name)

    def close_session(self, name: str) -> None:
        self._child(name).close_session(name)

    def reset_session(self, name: str) -> None:
        self._child(name).reset_session(name)

    def configure_session(self, name: str, **kwargs: Any) -> None:
        self._child(name).configure_session(name, **kwargs)

    def session_config(self, name: str) -> Dict[str, Any]:
        return self._child(name).session_config(name)

    # -------------------------------------------------------------- intake
    def submit(
        self, name: str, *args: Any, return_value: bool = False, **kwargs: Any
    ) -> Optional[ValueTicket]:
        return self._child(name).submit(
            name, *args, return_value=return_value, **kwargs
        )

    def update(self, name: str, *args: Any, **kwargs: Any) -> None:
        self._child(name).update(name, *args, **kwargs)

    def forward(self, name: str, *args: Any, **kwargs: Any) -> Any:
        return self._child(name).forward(name, *args, **kwargs)

    def flush(self) -> int:
        return sum(c.flush() for c in self.shards)

    def drain(self) -> None:
        for c in self.shards:
            c.drain()

    def shutdown(self) -> None:
        for c in self.shards:
            c.shutdown()

    # ------------------------------------------------------------- results
    def compute(self, name: str, **kwargs: Any) -> Any:
        return self._child(name).compute(name, **kwargs)

    def compute_all(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for c in self.shards:
            out.update(c.compute_all())
        return out

    def compute_window(self, name: Optional[str] = None) -> Any:
        if name is not None:
            return self._child(name).compute_window(name)
        out = {}
        for c in self.shards:
            out.update(c.compute_window())
        return out

    def state_digest(self, names: Optional[List[str]] = None) -> str:
        # the shards' digests, concatenated in shard order
        h = hashlib.sha1()
        for c in self.shards:
            h.update(c.state_digest(names).encode())
        return h.hexdigest()

    digest = state_digest

    # ---------------------------------------------------------- durability
    def checkpoint(self, path: Optional[str] = None) -> str:
        paths = [
            c.checkpoint(None if path is None else f"{path}.shard{k}")
            for k, c in enumerate(self.shards)
        ]
        return paths[0] if path is None else path

    def restore(self, path: Optional[str] = None, **kwargs: Any) -> Any:
        return [
            c.restore(None if path is None else f"{path}.shard{k}", **kwargs)
            for k, c in enumerate(self.shards)
        ]

    def recover(self, path: Optional[str] = None) -> bool:
        got = [
            c.recover(None if path is None else f"{path}.shard{k}")
            for k, c in enumerate(self.shards)
        ]
        return any(got)

    # ---------------------------------------------------------- time travel
    def compute_at(self, t: float, name: Optional[str] = None) -> Any:
        """Point-in-time read across the capacity shards: with ``name`` its
        shard's, else the union of every shard's (each resolves ``t`` against
        its own journal)."""
        if name is not None:
            return self._child(name).compute_at(t, name)
        out: Dict[str, Any] = {}
        for c in self.shards:
            out.update(c.compute_at(t))
        return out

    def compute_range(self, t1: float, t2: float, name: Optional[str] = None) -> Any:
        if name is not None:
            return self._child(name).compute_range(t1, t2, name)
        out: Dict[str, Any] = {}
        for c in self.shards:
            out.update(c.compute_range(t1, t2))
        return out

    def scrub(self, path: Optional[str] = None, *, quarantine: bool = True) -> Dict[str, Any]:
        reports = [
            c.scrub(None if path is None else f"{path}.shard{k}", quarantine=quarantine)
            for k, c in enumerate(self.shards)
        ]
        return {
            "checked": sum(r["checked"] for r in reports),
            "quarantined": [p for r in reports for p in r["quarantined"]],
            "shards": reports,
        }

    # --------------------------------------------------------------- stats
    @property
    def stats(self) -> Dict[str, int]:  # type: ignore[override]
        out: Dict[str, int] = {}
        for c in self.shards:
            for k, v in c.stats.items():
                out[k] = out.get(k, 0) + int(v)
        return out

    def memory_snapshot(self, top_n: int = 10) -> Dict[str, Any]:
        """``total_bytes`` / ``per_session_bytes`` are per-shard maxima (what
        one device holds), ``logical_bytes`` the sum over shards."""
        snaps = [c.memory_snapshot(top_n=top_n) for c in self.shards]
        by_name: Dict[str, Dict[str, Any]] = {}
        for snap in snaps:
            for leaf in snap["leaves"]:
                agg = by_name.setdefault(
                    leaf["name"],
                    {**leaf, "nbytes": 0, "logical_nbytes": 0},
                )
                agg["nbytes"] = max(agg["nbytes"], leaf["nbytes"])
                agg["logical_nbytes"] += leaf["logical_nbytes"]
        leaves = sorted(by_name.values(), key=lambda leaf: (-leaf["nbytes"], leaf["name"]))
        return {
            "total_bytes": max(s["total_bytes"] for s in snaps),
            "logical_bytes": sum(s["total_bytes"] for s in snaps),
            "leaf_count": snaps[0]["leaf_count"],
            "per_session_bytes": max(s["per_session_bytes"] for s in snaps),
            "n_shards": self.n_shards,
            "leaves": leaves[: max(0, int(top_n))],
        }

    def health(self) -> Dict[str, Any]:
        return {"shards": [c.health() for c in self.shards]}

    def slo_snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for c in self.shards:
            out.update(c.slo_snapshot())
        return out

    def telemetry_snapshot(self) -> Dict[str, Any]:
        return {
            "owner": self.label,
            "n_shards": self.n_shards,
            "sessions": self.session_count,
            "serve": dict(self.stats),
            "memory": self.memory_snapshot(),
            "shards": [c.telemetry_snapshot() for c in self.shards],
        }
