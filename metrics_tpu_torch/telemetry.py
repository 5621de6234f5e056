"""One span stream for every hot-path phase of the port.

Port of ``metrics_tpu/telemetry.py``, with the same event names, kinds,
attributes, counters, record formats and switches, so that a session of the
port exports what ``tools/trace_report.py`` reads from the JAX package. Every
hot-path phase is one :class:`TelemetryEvent`:

========== ============================================================
``name``   what one event stands for
========== ============================================================
update     one update through an engine or the eager path (kinds
           ``aot`` for a metric's captured program, ``fused-aot`` for a
           collection's, ``window-tick`` for
           :func:`~metrics_tpu_torch.ops.fused_window_tick`, ``eager`` for
           a metric without ``jit_update``, ``jit`` for the eager call that
           serves a ``jit_update`` call the engine declined: the JAX
           package's ``jax.jit`` fallback)
forward    one fused forward step through an engine (kinds ``aot`` /
           ``fused-aot``)
compute    one actual (non-memoised) ``compute()`` body
sync       one cross-process state sync pass
reset      one ``reset()`` (an instant: zero duration)
compile    one program built by an engine (on the card: a warm-up run and
           two CUDA graph captures), tagged with why (``cause``:
           ``first-compile`` / ``new-static-key`` / ``new-shape-bucket`` /
           ``new-dtype`` / ``new-signature``)
collective one collective on the wire (kinds ``fused`` for a bucket,
           ``gather`` / ``reduce`` for a leaf), with its ``nbytes``
degrade    one resilience demotion (kinds ``forward`` / ``dispatch`` /
           ``update`` / ``fused`` / ``collective`` / ``sync`` / ...),
           tagged with why (``cause``: ``injected:<fault>`` /
           ``unsupported`` / ``state-corruption`` / ``unfusable`` / the
           exception's type name / ``recovered``) and the cooldown
evict      one LRU eviction from an engine's program cache
           (``METRICS_TPU_CACHE_MAX``)
kernel     one launch of a registry kernel outside a graph capture, with
           its analytic cost attributes
           (:mod:`metrics_tpu_torch.ops.registry`)
window     one streaming-window operation on the eager path
           (:mod:`metrics_tpu_torch.streaming.window`): kinds ``advance``,
           ``update``, ``compute``, ``cascade``
sketch     one sketch-aggregator operation on the eager path
           (:mod:`metrics_tpu_torch.streaming.sketch`): kinds ``update`` /
           ``compute``, with the sketch's geometry
read       one window read: ``window-cached`` / ``window-rebuild`` (with
           the ``merges`` paid) and ``window-range``; and one serving read
           (:mod:`metrics_tpu_torch.serve`): ``memo-hit``, ``memo-miss``,
           ``batch`` (a ``compute_all`` of its ``dirty`` rows),
           ``time-travel`` (a ``compute_at`` / ``compute_range``); and one
           fabric read (:mod:`metrics_tpu_torch.fabric`): ``fleet`` /
           ``rollup``, with ``shards``, ``dirty``, ``memoized`` and its
           packed ``collectives`` (the packed gather itself is one
           ``collective`` span of kind ``packed-read``)
failover   one shard recovered on a peer (:mod:`metrics_tpu_torch.fabric`),
           with its ``cause``, ``epoch``, ``peer``, ``ms`` and, for a
           promoted standby, the records ``replayed``; ``handoff`` a
           planned move of sessions, ``membership`` a shard added or
           removed, ``replicate`` a journal ship or re-seed,
           ``anti-entropy`` a standby's check, ``suspect`` a shard the
           suspicion sweep quarantines
request    one admitted ``submit()``'s flight record
           (:mod:`metrics_tpu_torch.serve`), from submit to retirement, on
           the submitting thread's lane: kinds ``served`` / ``fallback`` /
           ``shed`` / ``expired`` / ``failed``, with its ``rid``,
           ``session``, ``queue_us`` / ``journal_us`` / ``launch_us`` /
           ``retire_us``, ``replayed=True`` for a journal replay, and with
           billing on its ``cost_microusd`` share of its launch; the Chrome
           export draws each one as a flow arrow (``ph`` ``s``/``t``/``f``)
journal    one write-ahead-journal operation (:mod:`metrics_tpu_torch.wal`):
           ``append`` (a durable record, with its frame ``nbytes``, also
           summed in the ``journal:bytes`` counter), ``replay`` (one
           recovery pass, with its record count), ``truncate``
checkpoint one serving checkpoint written (crc32 checksums attached)
gauge      one health (queue depth, inflight, sessions, free rows) and one
           memory (state bytes, top leaves) reading a flush, while a
           session listens
========== ============================================================

An engine's ``update`` and ``forward`` span (:mod:`metrics_tpu_torch.dispatch`)
covers the whole call, the owner's own part included (a collection's
fusability check, snapshot and member bookkeeping), and carries its four
host stages as attributes, each one ``perf_counter()`` read
(:class:`Stages`): ``prepare_us`` (fusability, snapshot, flatten,
canonicalize, the program's key and lookup), ``stage_us`` (the copies into
the graph's static inputs and the row-count and merge-count fills),
``launch_us`` (``graph.replay()``: where a full command buffer blocks the
host) and ``install_us`` (the leaves written back, verification, the
owner's bookkeeping); the call's host work is its duration less
``launch_us``. It also carries ``rows``, the batch's true dim-0 length, and
``bucket``, the rows the program ran (the padded bucket of a masked
program, else ``rows``).

The serving service's launches are ``update`` spans of kind ``stacked-aot``
(one a flush and signature: a CUDA graph replay on the card) with the
program's cost-model attributes and, with billing on, its modelled
occupancy and micro-dollars (:mod:`metrics_tpu_torch.analysis.billing`);
each build is a ``compile`` span of the same kind. ``aot-cache`` events belong
to the JAX package's persistent program tier, which the port does not have (a
CUDA graph cannot be serialized across processes; the ``nvcc`` builds persist
in :mod:`metrics_tpu_torch.ops._build`): nothing here emits one, and the
counters below read them as the JAX package does.

Events carry the owner (a metric's class name, ``MetricCollection`` or
``ops.<kernel>``), a kind, a start and a duration in µs of host wall time
(``time.perf_counter``: never a device synchronisation), the emitting
thread, and attributes that hold Python numbers and strings only, never a
tensor. Two tiers consume them:

* **Always-on counters.** Every emit bumps a process-level counter keyed
  ``"<name>:<kind>"`` (plus ``"collective:bytes"``,
  ``"compile:cause:<cause>"``, ``"degrade:cause:<cause>"``, the
  integer-microdollar ``"billing:microusd"``, which only serving spans
  feed, and the port's own ``"update:rows"`` and ``"update:bucket_rows"``,
  summed from the engine ``update`` spans' ``rows`` and ``bucket``, whose
  ratio is the engine's useful share of the rows it ran, and
  ``"format:labels"`` and ``"format:onehot"``, one a member update whose
  classification inputs took that formatting route (``"labels"``: class
  labels, no one-hots), and ``"extract:images"`` and ``"extract:resized"``, the images through the
  bundled InceptionV3's trunk and those it resized first; all four ticked
  by :func:`tick`): read with :func:`snapshot`, clear with
  :func:`reset_counters`.
* **Always-on timeline.** Every timed span also feeds a per-``(family,
  owner)`` latency and throughput aggregate: a
  :class:`~metrics_tpu_torch.streaming.sketch.HostQuantileSketch` of span µs
  and a ring of one-second buckets. Read with :func:`timeline`; turn it off
  with ``METRICS_TPU_TIMELINE=0``, after which :func:`clock` returns
  ``None`` while nothing is subscribed and the hot paths skip the clock.
* **Subscribed sessions.** ``with telemetry.instrument() as session:``
  captures every event with its timestamps; export with
  :meth:`TelemetrySession.export_chrome_trace` (Perfetto,
  ``chrome://tracing``) or :meth:`TelemetrySession.export_jsonl` (replay
  with ``tools/trace_report.py``). Sessions nest. A session records, when
  it opens, the offset from the stream's clock to the ``torch.profiler``'s
  (Unix-epoch µs, :func:`profiler_clock_offset_us`): the Chrome export
  carries it as ``otherData.stream_offset_us``, and the JSON-lines export
  gives each event its ``profiler_ts_us`` beside ``ts_us``, so that either
  lines up with a profiler trace taken in the same process.

The ``profiling.track_*`` trackers are subscribers of this stream
(:mod:`metrics_tpu_torch.profiling`).

While a ``torch.profiler`` records, the program also opens
``record_function`` ranges (:func:`profiler_range`): an engine call's
``metrics_tpu.<label>.update[<kind>]`` (``forward[...]``, ``scan[...]``)
over the whole call, with one child range a stage,
``metrics_tpu.<label>.update.<stage>``; a metric's ``compute`` and
``reset``; a collection's ``metrics_tpu.MetricCollection.compute`` and
``.reset``. Inside a captured engine program the device marks of
:mod:`metrics_tpu_torch.ops.marks` split the replay's device time by phase.

``METRICS_TPU_TELEMETRY=0`` (or ``false``/``off``) turns the whole engine
off: no counters, no events, no tracker records, no kernel cost entries,
no profiler ranges and no device marks in graphs captured then. The
per-owner stats (``Metric.dispatch_stats`` and the others) are counted at
the call sites and stay live regardless.
"""
import contextlib
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, ContextManager, Dict, Generator, Iterable, List, NamedTuple, Optional, Tuple

import torch

__all__ = [
    "TelemetryEvent",
    "TelemetrySession",
    "telemetry_enabled",
    "subscribed",
    "timeline_enabled",
    "timeline",
    "reset_timeline",
    "instrument",
    "emit",
    "span",
    "clock",
    "stream_us",
    "set_thread_name",
    "thread_names",
    "snapshot",
    "reset_counters",
    "export_chrome_trace",
    "export_jsonl",
    "profiler_range",
    "profiler_clock_offset_us",
    "Stages",
    "annotate",
    "tick",
    "recording_ticks",
]

# all timestamps are µs since this process-level epoch (perf_counter is
# monotonic but has an arbitrary zero; pinning one epoch makes every
# exported trace internally consistent)
_EPOCH = time.perf_counter()

_lock = threading.Lock()
# immutable tuple swapped atomically under _lock: emit() reads the module
# global ONCE and iterates that snapshot, so a subscriber detaching on
# another thread can never mutate the sequence mid-record
_subscribers: Tuple[Callable[["TelemetryEvent"], None], ...] = ()
_counters: Dict[str, float] = {}
# tid -> human lane name for the Chrome exporter's ph:"M" thread_name
# metadata records. Populated lazily at emit time from the emitting
# thread's ``threading`` name and explicitly via :func:`set_thread_name`
# (the serving flush worker names itself "flush-worker").
_thread_names: Dict[int, str] = {}


def telemetry_enabled() -> bool:
    """Engine kill switch (env ``METRICS_TPU_TELEMETRY``, default on)."""
    return os.environ.get("METRICS_TPU_TELEMETRY", "1").strip().lower() not in ("0", "false", "off")


def timeline_enabled() -> bool:
    """Always-on timeline switch (env ``METRICS_TPU_TIMELINE``, default
    on; the engine kill switch silences it too)."""
    return os.environ.get("METRICS_TPU_TIMELINE", "1").strip().lower() not in ("0", "false", "off")


class TelemetryEvent(NamedTuple):
    """One timestamped span (or instant, when ``dur_us == 0``) on the stream.

    Attributes:
        name: the phase (``update``/``forward``/``compute``/``sync``/
            ``reset``/``compile``/``collective``).
        owner: who emitted it — a metric class name or ``MetricCollection``.
        kind: the launch flavor within the phase (``aot``/``fused-aot``/
            ``jit``/``eager``/``fused``/``gather``/``reduce``/...).
        ts_us: start time, µs since the process telemetry epoch.
        dur_us: wall duration in µs (0.0 for instants and for spans whose
            start predates the first subscriber).
        tid: emitting thread id (Chrome-trace lane).
        attrs: structured payload — ``nbytes``, ``rows``, ``bucket``,
            ``cause``, ``stream``, ``dtypes``, ...
    """

    name: str
    owner: str
    kind: str
    ts_us: float
    dur_us: float
    tid: int
    attrs: Dict[str, Any]


# ----------------------------------------------------------------- timeline
# seconds of sliding throughput window kept per (family, owner)
_TIMELINE_RING = 32
# lazy class ref: streaming.sketch imports this module at its top, so
# the dogfooded HostQuantileSketch must be imported at first use
_HostSketch: Any = None


class _FamilyTimeline:
    """One family+owner's always-on aggregate: a host DDSketch of span
    µs (bins=512, alpha=0.05 — ~5 % relative error over sub-µs..hours)
    plus a ring of one-second throughput buckets. Mutated only under the
    module ``_lock``."""

    __slots__ = ("sketch", "count", "total_us", "max_us", "ring_n", "ring_sec")

    def __init__(self) -> None:
        self.sketch = _HostSketch(bins=512, alpha=0.05)
        self.count = 0
        self.total_us = 0.0
        self.max_us = 0.0
        self.ring_n = [0] * _TIMELINE_RING
        self.ring_sec = [-1] * _TIMELINE_RING

    def add(self, dur_us: float, now: float) -> None:
        self.count += 1
        self.total_us += dur_us
        if dur_us > self.max_us:
            self.max_us = dur_us
        if dur_us > 0:
            self.sketch.add(dur_us)
        sec = int(now)
        idx = sec % _TIMELINE_RING
        if self.ring_sec[idx] != sec:
            self.ring_sec[idx] = sec
            self.ring_n[idx] = 0
        self.ring_n[idx] += 1


_timelines: Dict[Tuple[str, str], "_FamilyTimeline"] = {}


def _timeline_add(name: str, owner: str, dur_us: float, now: float) -> None:
    global _HostSketch
    if _HostSketch is None:
        from metrics_tpu_torch.streaming.sketch import HostQuantileSketch

        _HostSketch = HostQuantileSketch
    key = (name, owner)
    with _lock:
        tl = _timelines.get(key)
        if tl is None:
            tl = _timelines[key] = _FamilyTimeline()
        tl.add(dur_us, now)


def timeline(owner: Optional[str] = None) -> Dict[str, Dict[str, Any]]:
    """The always-on per-family latency/throughput view.

    Returns ``{family: {count, total_us, mean_us, max_us, p50_us,
    p95_us, p99_us, rate_per_s}}`` aggregated over every owner (the
    per-owner sketches merge losslessly — same DDSketch geometry), or
    over owners containing the ``owner`` substring when given (a fabric
    passes ``"@shard3"`` to get one shard's view). ``rate_per_s`` is
    events/second over the sliding :data:`_TIMELINE_RING`-second window;
    the quantiles are lifetime (sliding-window quantiles would need a
    decaying sketch — the ratchet pins structure, not decay policy).
    """
    now = time.perf_counter()
    sec = int(now)
    with _lock:
        groups: Dict[str, List[_FamilyTimeline]] = {}
        for (family, own), tl in _timelines.items():
            if owner is not None and owner not in own:
                continue
            groups.setdefault(family, []).append(tl)
        out: Dict[str, Dict[str, Any]] = {}
        for family, tls in sorted(groups.items()):
            count = sum(t.count for t in tls)
            total = sum(t.total_us for t in tls)
            merged = tls[0].sketch
            if len(tls) > 1:
                merged = _HostSketch(bins=512, alpha=0.05)
                for t in tls:
                    merged.merge(t.sketch)
            recent = 0
            oldest = sec
            for t in tls:
                for s, n in zip(t.ring_sec, t.ring_n):
                    if 0 <= sec - s < _TIMELINE_RING:
                        recent += n
                        if s < oldest:
                            oldest = s
            span_s = max(1, min(_TIMELINE_RING, sec - oldest + 1))

            def _q(q: float) -> float:
                v = merged.quantile(q)
                return round(v, 3) if v == v else 0.0

            out[family] = {
                "count": count,
                "total_us": round(total, 3),
                "mean_us": round(total / count, 3) if count else 0.0,
                "max_us": round(max(t.max_us for t in tls), 3),
                "p50_us": _q(0.50),
                "p95_us": _q(0.95),
                "p99_us": _q(0.99),
                "rate_per_s": round(recent / span_s, 3),
            }
        return out


def reset_timeline() -> None:
    """Drop every timeline aggregate (tests / bench isolation)."""
    with _lock:
        _timelines.clear()


# ----------------------------------------------------------------- emission
def _subscribe(callback: Callable[[TelemetryEvent], None]) -> None:
    global _subscribers
    with _lock:
        _subscribers = _subscribers + (callback,)


def _unsubscribe(callback: Callable[[TelemetryEvent], None]) -> None:
    global _subscribers
    with _lock:
        subs = list(_subscribers)
        if callback in subs:
            subs.remove(callback)
        _subscribers = tuple(subs)


def clock() -> Optional[float]:
    """Span start marker: ``perf_counter()`` when someone will receive the
    span — a subscriber, or the always-on timeline — else ``None`` so
    idle hot paths never pay the clock read. With the timeline at its
    default-on setting this returns a real timestamp even unsubscribed
    (the idle cost is the clock read plus one sketch bin increment at
    emit; ``METRICS_TPU_TIMELINE=0`` restores the old idle no-op). Pass
    the result to :func:`emit` as ``t0``."""
    if telemetry_enabled() and (_subscribers or timeline_enabled()):
        return time.perf_counter()
    return None


def subscribed() -> bool:
    """True when at least one :func:`instrument` session (or
    tracker) will receive full events. Hot paths use this to skip
    building optional attr payloads (e.g. the roofline cost attrs) that
    only subscribed sessions ever read."""
    return bool(_subscribers) and telemetry_enabled()


def stream_us(t: float) -> float:
    """Convert a ``perf_counter()`` reading to stream time (µs since the
    process telemetry epoch — the ``ts_us`` unit every event carries).
    Used by emitters that stash extra timeline anchors in span attrs
    (e.g. the serving flight recorder's ``launch_ts_us``)."""
    return (t - _EPOCH) * 1e6


def set_thread_name(name: str, tid: Optional[int] = None) -> None:
    """Name the Chrome-trace lane for a thread (default: the calling
    thread). Exported traces then label the lane with ``name`` via a
    ``ph:"M"`` ``thread_name`` metadata record instead of the raw tid."""
    with _lock:
        _thread_names[tid if tid is not None else threading.get_ident()] = str(name)


def thread_names() -> Dict[int, str]:
    """Copy of the tid -> lane-name registry (explicit
    :func:`set_thread_name` entries plus names captured at emit time)."""
    with _lock:
        return dict(_thread_names)


def emit(
    name: str,
    owner: str,
    kind: str = "",
    t0: Optional[float] = None,
    dur_us: Optional[float] = None,
    tid: Optional[int] = None,
    **attrs: Any,
) -> None:
    """Record one event on the stream.

    ``t0`` (a :func:`clock` result) sets the span start; the duration is
    measured to now unless ``dur_us`` is given explicitly (callers that
    already timed the work pass both). With neither, the event is an
    instant at now. ``tid`` pins the event to another thread's lane (the
    serving flight recorder emits ``request`` spans at retirement but on
    the submitting thread's lane). Counters are bumped even with no
    subscriber attached; full events are built and delivered only when
    someone is listening.
    """
    if not telemetry_enabled():
        return
    subs = _subscribers
    ckey = f"{name}:{kind}" if kind else name
    with _lock:
        _counters[ckey] = _counters.get(ckey, 0) + 1
        if name == "collective":
            _counters["collective:bytes"] = _counters.get("collective:bytes", 0) + attrs.get("nbytes", 0)
        elif name == "compile":
            cause = attrs.get("cause", "unattributed")
            _counters[f"compile:cause:{cause}"] = _counters.get(f"compile:cause:{cause}", 0) + 1
        elif name == "degrade":
            cause = attrs.get("cause", "unattributed")
            _counters[f"degrade:cause:{cause}"] = _counters.get(f"degrade:cause:{cause}", 0) + 1
        elif name == "journal" and kind == "append":
            _counters["journal:bytes"] = _counters.get("journal:bytes", 0) + attrs.get("nbytes", 0)
        elif name == "update" and attrs.get("rows") is not None:
            # the engine's rows against the rows its program ran: the padding's share
            _counters["update:rows"] = _counters.get("update:rows", 0) + attrs["rows"]
            _counters["update:bucket_rows"] = _counters.get("update:bucket_rows", 0) + attrs["bucket"]
        elif name == "request" and "cost_microusd" in attrs:
            # dollar attribution rides the always-on counters as integer
            # microdollars (exact under summation; absent entirely when
            # METRICS_TPU_BILLING=0 keeps spans cost-free)
            _counters["billing:microusd"] = _counters.get("billing:microusd", 0) + int(attrs.get("cost_microusd") or 0)
        if name in ("update", "forward"):
            for counter in TICKED:  # an engine program's ticks, once a call, as tick counts them eagerly
                n = attrs.get(counter.replace(":", "_"))
                if n:
                    _counters[counter] = _counters.get(counter, 0) + n
    timed = t0 is not None or dur_us is not None
    if not subs and not timed:
        return
    now = time.perf_counter()
    if dur_us is None:
        dur_us = 0.0 if t0 is None else (now - t0) * 1e6
    if timed and timeline_enabled():
        _timeline_add(name, owner, dur_us, now)
    if not subs:
        return
    if t0 is not None:
        ts_us = (t0 - _EPOCH) * 1e6
    else:
        ts_us = (now - _EPOCH) * 1e6 - dur_us
    own_tid = threading.get_ident()
    if own_tid not in _thread_names:
        # lazy lane naming: capture the threading name once per thread so
        # exported traces label lanes even without explicit registration
        with _lock:
            _thread_names.setdefault(own_tid, threading.current_thread().name)
    event = TelemetryEvent(
        name, owner, kind, ts_us, dur_us, own_tid if tid is None else tid, attrs
    )
    for callback in subs:
        callback(event)


@contextmanager
def span(name: str, owner: str, kind: str = "", **attrs: Any) -> Generator[None, None, None]:
    """Wrap a block in one timed span (emitted on exit, even on raise); code
    inside it adds attributes with :func:`annotate`."""
    t0 = clock()
    stack = getattr(_span_local, "stack", None)
    if stack is None:
        stack = _span_local.stack = []
    stack.append(attrs)
    try:
        yield
    finally:
        stack.pop()
        emit(name, owner, kind, t0=t0, **attrs)


def annotate(**attrs: Any) -> None:
    """Add ``attrs`` to the innermost open :func:`span` of this thread (FID's
    ``compute`` names the square root it took); outside one, nothing."""
    stack = getattr(_span_local, "stack", None)
    if stack:
        stack[-1].update(attrs)


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled() and telemetry_enabled()


def profiler_range(name: str) -> ContextManager:
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler records (and telemetry is on), else a no-op context: the
    counterpart of the JAX package's ``profiler_annotation``
    (``metrics_tpu/_compat.py:66``), which costs nothing outside a trace.
    Engine calls, ``compute`` and ``reset`` wrap themselves in one, so a
    profiler's trace lines up with this stream."""
    if _profiling():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


STAGES = ("prepare", "stage", "launch", "install")


class Stages:
    """The host stages of one engine call (:data:`STAGES`, in order), one
    ``perf_counter()`` read a boundary; while a profiler records, also its
    ranges: ``metrics_tpu.<label>.<family>[<kind>]`` over the whole call and
    ``metrics_tpu.<label>.<family>.<stage>`` inside it, one a stage.

    The call begins in ``prepare``; :meth:`enter` moves it on (a stage the
    call skips reads 0), :meth:`restart` starts its clock again after a
    program build (the span, as the JAX engine's, starts after the compile),
    and :meth:`close` ends it: it closes the ranges and returns the stages'
    µs as ``{"<stage>_us": ...}``; leaving a ``with`` block closes it too.
    ``t0`` is the call's start, for its span.
    """

    __slots__ = ("t0", "_t", "_i", "_us", "_prefix", "_ranges")

    def __init__(self, label: str, family: str, kind: str) -> None:
        self.t0 = self._t = time.perf_counter()
        self._i = 0
        self._us = [0.0] * len(STAGES)
        self._ranges: Optional[List[Any]] = None
        if _profiling():
            self._prefix = f"metrics_tpu.{label}.{family}"
            self._ranges = [torch.profiler.record_function(f"{self._prefix}[{kind}]").__enter__(),
                            torch.profiler.record_function(f"{self._prefix}.{STAGES[0]}").__enter__()]

    def enter(self, stage: str) -> None:
        i = STAGES.index(stage)
        if i == self._i or self._i < 0:  # already there, or closed
            return
        t = time.perf_counter()
        self._us[self._i] += (t - self._t) * 1e6
        self._t, self._i = t, i
        if self._ranges:
            self._ranges.pop().__exit__(None, None, None)
            self._ranges.append(torch.profiler.record_function(f"{self._prefix}.{stage}").__enter__())

    def __enter__(self) -> "Stages":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def restart(self) -> None:
        self.t0 = self._t = time.perf_counter()
        self._us = [0.0] * len(STAGES)

    def close(self) -> Dict[str, float]:
        """End the call (once; a second close returns the same stages)."""
        if self._i >= 0:
            self._us[self._i] += (time.perf_counter() - self._t) * 1e6
            self._i = -1
            while self._ranges:
                self._ranges.pop().__exit__(None, None, None)
        return {f"{stage}_us": us for stage, us in zip(STAGES, self._us)}


def profiler_clock_offset_us() -> float:
    """µs to add to a stream time (``ts_us``) to put it on the clock of the
    ``torch.profiler``'s events: Unix-epoch µs (an event's start is the
    trace's ``trace_start_ns()`` plus its ``time_range.start``). Read as the
    tightest of a few paired reads of ``perf_counter`` and ``time_ns``."""
    best = (float("inf"), 0.0)
    for _ in range(5):
        a = time.perf_counter()
        wall = time.time_ns()
        b = time.perf_counter()
        if b - a < best[0]:
            best = (b - a, wall / 1e3 - ((a + b) / 2 - _EPOCH) * 1e6)
    return best[1]


# ----------------------------------------------------------------- counters
def snapshot() -> Dict[str, float]:
    """Copy of the process-level counters (``"<name>:<kind>"`` keys, plus
    ``"collective:bytes"``, ``"compile:cause:<cause>"``,
    ``"degrade:cause:<cause>"``, ``"update:rows"``,
    ``"update:bucket_rows"`` and the :data:`TICKED` counters)."""
    with _lock:
        return dict(_counters)


def reset_counters() -> None:
    """Zero the process-level counters (subscribed sessions are untouched)."""
    with _lock:
        _counters.clear()


# --------------------------------------------------------------- ticked counters
# the counters that the program's own code ticks (:func:`tick`); an engine program's ride its spans
TICKED = ("format:labels", "format:onehot", "extract:images", "extract:resized")
_tick_local = threading.local()
_span_local = threading.local()


def tick(counter: str, n: int = 1) -> None:
    """Add ``n`` to ``counter``, one of :data:`TICKED`. Inside
    :func:`recording_ticks` (an engine running a program's body) the tick is
    written down instead: the program's spans carry it, once a call
    (:func:`tick_attrs`), and :func:`emit` counts it from there."""
    stack = getattr(_tick_local, "stack", None)
    if stack:
        stack[-1].append((counter, int(n)))
    elif telemetry_enabled():
        with _lock:
            _counters[counter] = _counters.get(counter, 0) + int(n)


@contextmanager
def recording_ticks() -> Generator[List[Tuple[str, int]], None, None]:
    """Write the block's :func:`tick` calls down, in order, as ``(counter, n)``
    into the list it yields, and count none of them."""
    stack = getattr(_tick_local, "stack", None)
    if stack is None:
        stack = _tick_local.stack = []
    ticks: List[Tuple[str, int]] = []
    stack.append(ticks)
    try:
        yield ticks
    finally:
        stack.pop()


def tick_attrs(ticks: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """A program's recorded ticks as its span's attributes, one a counter it
    ticks (``format_labels``, ``extract_images``, ...), summed."""
    out: Dict[str, int] = {}
    for counter, n in ticks:
        key = counter.replace(":", "_")
        out[key] = out.get(key, 0) + n
    return out


# ------------------------------------------------------------------ sessions
class TelemetrySession:
    """The event stream captured by one :func:`instrument` context.

    ``events`` is append-only in emission order; the helpers below are
    conveniences over it. Safe to read concurrently with emission — the
    recorder holds a session-local lock around the append.
    """

    def __init__(self) -> None:
        self.events: List[TelemetryEvent] = []
        self._session_lock = threading.Lock()
        # µs from the stream's clock to the torch.profiler's, taken as the session opens
        self.profiler_offset_us = profiler_clock_offset_us()

    def _record(self, event: TelemetryEvent) -> None:
        with self._session_lock:
            self.events.append(event)

    # -------------------------------------------------------------- queries
    def spans(
        self,
        name: Optional[str] = None,
        kind: Optional[str] = None,
        owner: Optional[str] = None,
    ) -> List[TelemetryEvent]:
        """Events filtered by exact ``name``/``kind`` and ``owner`` substring."""
        with self._session_lock:
            events = list(self.events)
        return [
            e
            for e in events
            if (name is None or e.name == name)
            and (kind is None or e.kind == kind)
            and (owner is None or owner in e.owner)
        ]

    def count(self, name: Optional[str] = None, kind: Optional[str] = None, owner: Optional[str] = None) -> int:
        return len(self.spans(name=name, kind=kind, owner=owner))

    def retrace_causes(self) -> Dict[str, int]:
        """``{cause: count}`` over every ``compile`` event in the session."""
        causes: Dict[str, int] = {}
        for e in self.spans(name="compile"):
            cause = e.attrs.get("cause", "unattributed")
            causes[cause] = causes.get(cause, 0) + 1
        return causes

    def collective_bytes(self) -> int:
        """Total payload bytes over every ``collective`` event."""
        return sum(int(e.attrs.get("nbytes", 0)) for e in self.spans(name="collective"))

    # ------------------------------------------------------------- exporters
    def export_chrome_trace(self, path: str) -> None:
        export_chrome_trace(self.spans(), path, self.profiler_offset_us)

    def export_jsonl(self, path: str) -> None:
        export_jsonl(self.spans(), path, self.profiler_offset_us)


@contextmanager
def instrument() -> Generator[TelemetrySession, None, None]:
    """Capture every telemetry event emitted inside the block.

    Contexts nest: each open session receives every event, so an inner
    session's stream is a contiguous subsequence of the outer's.
    """
    session = TelemetrySession()
    _subscribe(session._record)
    try:
        yield session
    finally:
        _unsubscribe(session._record)


# ------------------------------------------------------------------ exporters
def _jsonable(value: Any) -> Any:
    """Best-effort JSON coercion for attr payloads (dtypes, shape tuples,
    static-key tuples) — containers recurse, leaves fall back to ``str``."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    return str(value)


def export_jsonl(events: Iterable[TelemetryEvent], path: str, offset_us: Optional[float] = None) -> None:
    """One JSON object per line per event — the ``tools/trace_report.py``
    interchange format — with ``profiler_ts_us``, the start on the
    ``torch.profiler``'s clock (``ts_us`` plus ``offset_us``, by default
    :func:`profiler_clock_offset_us` now)."""
    offset = profiler_clock_offset_us() if offset_us is None else offset_us
    with open(path, "w") as f:
        for e in events:
            f.write(
                json.dumps(
                    {
                        "name": e.name,
                        "owner": e.owner,
                        "kind": e.kind,
                        "ts_us": round(e.ts_us, 3),
                        "profiler_ts_us": round(e.ts_us + offset, 3),
                        "dur_us": round(e.dur_us, 3),
                        "tid": e.tid,
                        "attrs": _jsonable(e.attrs),
                    }
                )
                + "\n"
            )


def export_chrome_trace(events: Iterable[TelemetryEvent], path: str, offset_us: Optional[float] = None) -> None:
    """Chrome trace-event JSON (the ``traceEvents`` array form) — open in
    Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``. Timed spans
    become complete (``ph="X"``) events; zero-duration events become
    instants (``ph="i"``). ``ts`` is the stream's µs (exact to the ns);
    ``otherData.stream_offset_us`` (``offset_us``, by default
    :func:`profiler_clock_offset_us` now) puts it on the
    ``torch.profiler``'s clock, Unix-epoch µs, where a float no longer
    holds the ns, so that the file lines up with a profiler trace of the
    process.

    Two extra record families make the trace readable as a story rather
    than a pile of slices:

    * ``ph:"M"`` metadata — one ``process_name`` record plus a
      ``thread_name`` per lane (from :func:`set_thread_name` / the
      emit-time capture), so lanes read "flush-worker"/"submit-0"
      instead of raw tids.
    * ``ph:"s"/"t"/"f"`` flow events — synthesized from every
      ``request`` span that carries launch/retire anchors
      (``launch_ts_us``/``launch_tid``/``retire_ts_us``), so one
      submit is a single clickable arrow from its submit-lane span
      through the stacked launch to the retirement slice."""
    pid = os.getpid()
    events = list(events)
    offset = profiler_clock_offset_us() if offset_us is None else offset_us
    trace: List[Dict[str, Any]] = [
        {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
         "args": {"name": "metrics_tpu_torch"}},
    ]
    names = thread_names()
    for tid in sorted({e.tid for e in events}):
        trace.append({
            "ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
            "args": {"name": names.get(tid, f"thread-{tid}")},
        })
    for e in events:
        entry: Dict[str, Any] = {
            "name": f"{e.owner}.{e.name}" + (f" [{e.kind}]" if e.kind else ""),
            "cat": e.name,
            "pid": pid,
            "tid": e.tid,
            "ts": round(e.ts_us, 3),
            "args": {"owner": e.owner, "kind": e.kind, **_jsonable(e.attrs)},
        }
        if e.dur_us > 0:
            entry["ph"] = "X"
            entry["dur"] = round(e.dur_us, 3)
        else:
            entry["ph"] = "i"
            entry["s"] = "t"
        trace.append(entry)
        if e.name == "request" and "rid" in e.attrs:
            trace.extend(_request_flow(e, pid))
    with open(path, "w") as f:
        json.dump({"traceEvents": trace, "displayTimeUnit": "ms", "otherData": {"stream_offset_us": offset}}, f)


def _request_flow(e: TelemetryEvent, pid: int) -> List[Dict[str, Any]]:
    """Flow-event triple for one ``request`` span: start inside the span
    on the submit lane, step inside the launch slice on the flush lane,
    finish at the retirement point. Binding is positional — a flow record
    attaches to the slice enclosing its timestamp on that thread — so the
    anchors are placed strictly inside their slices."""
    flow: List[Dict[str, Any]] = []
    rid = e.attrs["rid"]
    base = {"cat": "request", "name": "request-flow", "id": rid, "pid": pid}
    flow.append({**base, "ph": "s", "tid": e.tid, "ts": round(e.ts_us + 0.001, 3)})
    launch_ts = e.attrs.get("launch_ts_us")
    launch_tid = e.attrs.get("launch_tid", e.tid)
    if launch_ts is not None:
        flow.append({**base, "ph": "t", "tid": launch_tid,
                     "ts": round(float(launch_ts) + 0.001, 3)})
    retire_ts = e.attrs.get("retire_ts_us")
    if retire_ts is not None:
        flow.append({**base, "ph": "f", "bp": "e", "tid": launch_tid,
                     "ts": round(float(retire_ts), 3)})
    return flow
