"""Dispatch, sync and forward trackers: subscribers of the telemetry stream.

Port of ``metrics_tpu/profiling.py``. The three tracker contexts keep the
JAX package's API (``dispatches``/``retraces``/``collectives``/
``bytes_on_wire``/``launches``/``events``) and are subscribers of the one
span stream of :mod:`metrics_tpu_torch.telemetry`. An adapter, attached to
the stream only while at least one tracker context is open, routes each
event to the tracker family it belongs to:

* ``update`` events (and ``forward`` events tagged ``stream="dispatch"``)
  go to :class:`DispatchTracker` as dispatches, ``compile`` events tagged
  ``stream="dispatch"`` as its retraces;
* ``forward`` events go to :class:`ForwardTracker` as launches (with the
  span's µs), ``compile`` events tagged ``stream="forward"`` as its
  retraces;
* ``collective`` events go to :class:`SyncTracker`, with their ``nbytes``.

The other phases (``compute``, ``sync``, ``reset``, ``kernel``, ...) are
routed nowhere. Forward launches are not dispatches: ``track_dispatches``
counts the update path and ``track_forwards`` the step path.

Usage (the three nest; each open context sees every event)::

    with track_dispatches() as tracker:
        collection.update(preds, target)
    assert tracker.dispatches == 1          # one fused launch for N metrics

    with track_syncs() as tracker:
        collection.compute()                # one collective per bucket
    assert tracker.collectives == tracker.buckets

Counting is host-side bookkeeping (no device work, no synchronisation).
``METRICS_TPU_TELEMETRY=0`` silences the trackers too; the per-owner stats
(``Metric.dispatch_stats`` and the others, merged by
``Metric.telemetry_snapshot()``) stay live. The ``record_*`` functions emit
onto the stream for callers outside the package.
"""
import threading
from contextlib import contextmanager
from typing import Dict, Generator, List, Optional, Tuple

from metrics_tpu_torch import telemetry

_lock = threading.Lock()
_active_trackers: List["DispatchTracker"] = []
_active_sync_trackers: List["SyncTracker"] = []
_active_forward_trackers: List["ForwardTracker"] = []
# how many tracker contexts are open across all three families; the
# telemetry adapter is subscribed while nonzero (so an idle process keeps
# telemetry's no-subscriber fast path)
_adapter_refs = 0


def _snapshot(trackers: List) -> List:
    # every record path iterates a snapshot taken UNDER the lock, so a
    # tracker unregistering on another thread can never raise mid-record
    with _lock:
        return list(trackers)


def _route_event(event: telemetry.TelemetryEvent) -> None:
    """Fan one telemetry event out to the tracker family it maps to."""
    name = event.name
    stream = event.attrs.get("stream")
    if name == "update" or (name == "forward" and stream == "dispatch"):
        for tracker in _snapshot(_active_trackers):
            tracker._record_dispatch(event.owner, event.kind)
    elif name == "compile":
        if stream == "forward":
            for tracker in _snapshot(_active_forward_trackers):
                tracker._record_retrace(event.owner, event.kind)
        else:
            for tracker in _snapshot(_active_trackers):
                tracker._record_retrace(event.owner, event.kind)
    elif name == "forward":
        for tracker in _snapshot(_active_forward_trackers):
            tracker._record_launch(event.owner, event.kind, event.dur_us)
    elif name == "collective":
        nbytes = int(event.attrs.get("nbytes", 0))
        logical = int(event.attrs.get("logical_nbytes", nbytes))
        for tracker in _snapshot(_active_sync_trackers):
            tracker._record(event.owner, event.kind, nbytes, logical)


def _activate(trackers: List, tracker) -> None:
    global _adapter_refs
    with _lock:
        trackers.append(tracker)
        _adapter_refs += 1
        attach = _adapter_refs == 1
    if attach:
        telemetry._subscribe(_route_event)


def _deactivate(trackers: List, tracker) -> None:
    global _adapter_refs
    with _lock:
        trackers.remove(tracker)
        _adapter_refs -= 1
        detach = _adapter_refs == 0
    if detach:
        telemetry._unsubscribe(_route_event)


class DispatchTracker:
    """Aggregated dispatch/retrace counts recorded while a context is open.

    Attributes:
        dispatches: total device-program launches recorded (all kinds).
        retraces: total compilations recorded (all kinds).
        events: ``(owner, kind)`` tuples in record order, for debugging.
    """

    def __init__(self) -> None:
        self.dispatches = 0
        self.retraces = 0
        self.events: List[Tuple[str, str]] = []
        self._dispatch_by_kind: Dict[str, int] = {}
        self._retrace_by_kind: Dict[str, int] = {}

    def dispatch_count(self, kind: Optional[str] = None, owner: Optional[str] = None) -> int:
        """Dispatches filtered by ``kind`` and/or an ``owner`` substring."""
        if kind is None and owner is None:
            return self.dispatches
        if owner is None:
            return self._dispatch_by_kind.get(kind, 0)
        return sum(
            1
            for o, k in self.events
            if not k.startswith("retrace:")
            and (kind is None or k == kind)
            and owner in o
        )

    def retrace_count(self, kind: Optional[str] = None) -> int:
        if kind is None:
            return self.retraces
        return self._retrace_by_kind.get(kind, 0)

    def _record_dispatch(self, owner: str, kind: str) -> None:
        self.dispatches += 1
        self._dispatch_by_kind[kind] = self._dispatch_by_kind.get(kind, 0) + 1
        self.events.append((owner, kind))

    def _record_retrace(self, owner: str, kind: str) -> None:
        self.retraces += 1
        self._retrace_by_kind[kind] = self._retrace_by_kind.get(kind, 0) + 1
        self.events.append((owner, f"retrace:{kind}"))


def record_dispatch(owner: str, kind: str) -> None:
    """Record one update-path device-program launch on behalf of ``owner``."""
    telemetry.emit("update", owner, kind, stream="dispatch")


def record_retrace(owner: str, kind: str) -> None:
    """Record one update-path compilation on behalf of ``owner``."""
    telemetry.emit("compile", owner, kind, stream="dispatch", cause="unattributed")


@contextmanager
def track_dispatches() -> Generator[DispatchTracker, None, None]:
    """Count every hot-path dispatch/retrace issued inside the block."""
    tracker = DispatchTracker()
    _activate(_active_trackers, tracker)
    try:
        yield tracker
    finally:
        _deactivate(_active_trackers, tracker)


class SyncTracker:
    """Aggregated sync-collective counts recorded while a context is open.

    Attributes:
        collectives: total cross-participant launches recorded (all kinds).
        buckets: how many of those were fused bucket collectives.
        bytes_on_wire: total payload bytes crossing the interconnect, summed
            over every recorded collective (the *launch* payload; an
            all-gather additionally returns ``world x`` that many bytes).
        bytes_logical: total pre-compression state bytes behind those
            payloads (``logical_nbytes`` span attr; equals ``bytes_on_wire``
            when nothing was compressed or quantized).
        events: ``(owner, kind, nbytes)`` tuples in record order.
    """

    def __init__(self) -> None:
        self.collectives = 0
        self.buckets = 0
        self.bytes_on_wire = 0
        self.bytes_logical = 0
        self.events: List[Tuple[str, str, int]] = []
        self._by_kind: Dict[str, int] = {}

    def collective_count(self, kind: Optional[str] = None, owner: Optional[str] = None) -> int:
        """Collectives filtered by ``kind`` and/or an ``owner`` substring."""
        if kind is None and owner is None:
            return self.collectives
        if owner is None:
            return self._by_kind.get(kind, 0)
        return sum(1 for o, k, _ in self.events if (kind is None or k == kind) and owner in o)

    def bytes_count(self, kind: Optional[str] = None, owner: Optional[str] = None) -> int:
        """Wire bytes filtered by ``kind`` and/or an ``owner`` substring."""
        if kind is None and owner is None:
            return self.bytes_on_wire
        return sum(n for o, k, n in self.events if (kind is None or k == kind) and (owner is None or owner in o))

    def _record(self, owner: str, kind: str, nbytes: int, logical: Optional[int] = None) -> None:
        self.collectives += 1
        self.bytes_on_wire += nbytes
        self.bytes_logical += nbytes if logical is None else logical
        if kind == "fused":
            self.buckets += 1
        self._by_kind[kind] = self._by_kind.get(kind, 0) + 1
        self.events.append((owner, kind, nbytes))


def record_collective(owner: str, kind: str, nbytes: int) -> None:
    """Record one sync collective (``fused``/``gather``/``reduce``) of
    ``nbytes`` payload bytes issued on behalf of ``owner``."""
    telemetry.emit("collective", owner, kind, nbytes=nbytes)


@contextmanager
def track_syncs() -> Generator[SyncTracker, None, None]:
    """Count every sync collective (and its wire bytes) issued inside the block."""
    tracker = SyncTracker()
    _activate(_active_sync_trackers, tracker)
    try:
        yield tracker
    finally:
        _deactivate(_active_sync_trackers, tracker)


class ForwardTracker:
    """Aggregated forward-engine counts recorded while a context is open.

    Attributes:
        launches: total single-launch fused forwards recorded (all kinds).
        retraces: total forward-program compilations recorded.
        engine_us: cumulative host-side dispatch time of the recorded
            launches in microseconds (wall time of the executable call —
            on async backends this is the dispatch cost, not device time).
        events: ``(owner, kind, us)`` tuples in record order; retrace
            events carry ``kind="retrace:<kind>"`` and zero µs.
    """

    def __init__(self) -> None:
        self.launches = 0
        self.retraces = 0
        self.engine_us = 0.0
        self.events: List[Tuple[str, str, float]] = []
        self._launch_by_kind: Dict[str, int] = {}
        self._retrace_by_kind: Dict[str, int] = {}

    def launch_count(self, kind: Optional[str] = None, owner: Optional[str] = None) -> int:
        """Launches filtered by ``kind`` and/or an ``owner`` substring."""
        if kind is None and owner is None:
            return self.launches
        if owner is None:
            return self._launch_by_kind.get(kind, 0)
        return sum(
            1
            for o, k, _ in self.events
            if not k.startswith("retrace:")
            and (kind is None or k == kind)
            and owner in o
        )

    def retrace_count(self, kind: Optional[str] = None) -> int:
        if kind is None:
            return self.retraces
        return self._retrace_by_kind.get(kind, 0)

    def _record_launch(self, owner: str, kind: str, us: float) -> None:
        self.launches += 1
        self.engine_us += us
        self._launch_by_kind[kind] = self._launch_by_kind.get(kind, 0) + 1
        self.events.append((owner, kind, us))

    def _record_retrace(self, owner: str, kind: str) -> None:
        self.retraces += 1
        self._retrace_by_kind[kind] = self._retrace_by_kind.get(kind, 0) + 1
        self.events.append((owner, f"retrace:{kind}", 0.0))


def record_forward(owner: str, kind: str, us: float) -> None:
    """Record one fused-forward launch of ``us`` microseconds for ``owner``."""
    telemetry.emit("forward", owner, kind, dur_us=us, stream="forward")


def record_forward_retrace(owner: str, kind: str) -> None:
    """Record one forward-program compilation on behalf of ``owner``."""
    telemetry.emit("compile", owner, kind, stream="forward", cause="unattributed")


@contextmanager
def track_forwards() -> Generator[ForwardTracker, None, None]:
    """Count every fused-forward launch/retrace issued inside the block."""
    tracker = ForwardTracker()
    _activate(_active_forward_trackers, tracker)
    try:
        yield tracker
    finally:
        _deactivate(_active_forward_trackers, tracker)
