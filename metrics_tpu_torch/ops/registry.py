"""The port's kernels, their launch counts, and the one routing rule.

Port of ``metrics_tpu/ops/registry.py``, cut down to what holds on the card:
a tensor on the CPU takes the kernel's plain PyTorch version, a tensor on a
CUDA device takes the hand-written kernel. There is no opt-in switch and no
fallback: a kernel that fails to build or launch raises.

Each wrapper adds one to its kernel's count where it launches the kernel,
and nowhere else, so a run can show that its path went through the kernels.
It names the branch it launched and the shape it launched at; those counts
are kept per ``(branch, shape)`` beside the total.

A launch made while a CUDA graph is captured runs nothing then: inside
:func:`recording` it is written down instead of counted, and the engine adds
the written launches again on every replay of that graph
(:func:`note_replay`), so the counts stay the kernels run on the card.

Cost entries (``metrics_tpu/ops/registry.py:208-270``): a wrapper passes its
launch's analytic terms (``cost_key``, ``flops``, ``bytes_accessed``: the
bytes its kernel must move and the operations it needs), and each launch
outside a capture records a ``kernel``-family entry of
:mod:`metrics_tpu_torch.analysis.cost_model` and emits one ``kernel``
telemetry event, owned by ``ops.<name>`` under the JAX package's kernel
names. So an eager call fires one event, a program build one for each
launch of its warm-up run, and a graph replay none (its ``update`` span
stands for it). A capture writes the terms down with the launch, and they
make up the program's own entry (:func:`cost_model.record`).
:func:`lowering` names the engine whose build is under way, and
:func:`engaged` which kernels each owner's programs or calls ran. With
telemetry off (``METRICS_TPU_TELEMETRY=0``) a launch is counted and nothing
else: no cost entry, no event, no engagement.

The spec table (``metrics_tpu/ops/registry.py:90-135, 264-281``): each kernel
module registers a :class:`KernelSpec` naming the metric families its kernel
covers, and :func:`kernel_status` gives the JAX package's ``yes`` /
``eligible`` / ``no`` verdict that ``tools/torch_trace_report.py``'s kernel
column reads. The JAX registry's opt-in switch (``pallas_enabled``,
``refresh``, ``resolve``) and its guarded ``launch`` have no counterpart: the
device of the tensor decides, and a failed launch raises.
"""
import ctypes
import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Set, Tuple

import torch

from metrics_tpu_torch import telemetry
from metrics_tpu_torch.analysis import cost_model

KERNELS = ("stat_scores", "confusion_matrix", "binned_stats", "retrieval_sort", "countmin")

# a kernel's owner in telemetry and cost entries: the JAX package's registered name where it differs
# (metrics_tpu/ops/sketch_ops.py:123)
EVENT_NAMES = {"countmin": "countmin_scatter"}

# a launch written down in a capture: (name, branch, shape, flops, bytes)
Launch = Tuple[str, str, Tuple[int, ...], float, float]

_launches: Dict[str, int] = {name: 0 for name in KERNELS}
_replayed: Dict[str, int] = {name: 0 for name in KERNELS}
_by_shape: Dict[str, Dict[Tuple[str, Tuple[int, ...]], int]] = {name: {} for name in KERNELS}
_limits: Dict[torch.device, Tuple[int, int]] = {}
# the launch lists of the captures under way on each thread, innermost last: a shard's capture on one thread
# must not write down another thread's eager launches
_recording_stack = threading.local()

_lock = threading.Lock()
# owners whose programs or calls ran a kernel, and the cost keys met so far (an event's first=)
_engaged_by_owner: Dict[str, Set[str]] = {}
_costed: Set[Tuple[str, str]] = set()
_lowering_owner = threading.local()


class KernelSpec:
    """One registered kernel: its name, kind (``"cuda"`` for a hand-written
    kernel, ``"fused-graph"`` for a captured program with no hand-written
    body), the owner-name substrings it covers (:func:`kernel_status`'s
    ``eligible``) and a one-line description."""

    __slots__ = ("name", "kind", "covers", "doc")

    def __init__(self, name: str, kind: str, covers: Tuple[str, ...], doc: str) -> None:
        self.name = name
        self.kind = kind
        self.covers = tuple(covers)
        self.doc = doc


_REGISTRY: Dict[str, KernelSpec] = {}


def register(name: str, kind: str, covers: Tuple[str, ...], doc: str) -> KernelSpec:
    """Register (idempotently) one kernel spec."""
    with _lock:
        spec = _REGISTRY.get(name)
        if spec is None:
            spec = _REGISTRY[name] = KernelSpec(name, kind, covers, doc)
    return spec


def get(name: str) -> KernelSpec:
    return _REGISTRY[name]


def specs() -> List[KernelSpec]:
    return list(_REGISTRY.values())


def names() -> List[str]:
    return sorted(_REGISTRY)


def kernel_status(owner: str, kind: str = "") -> str:
    """``yes`` where ``owner``'s programs or calls ran a registered kernel (or
    the row is an ``ops.*`` launch), ``eligible`` where a registered kernel
    covers the owner's family but did not run, else ``no``."""
    if owner.startswith("ops.") or kind == "kernel":
        return "yes"
    with _lock:
        if _engaged_by_owner.get(owner):
            return "yes"
    for spec in _REGISTRY.values():
        if any(c and c in owner for c in spec.covers):
            return "eligible"
    return "no"


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on mixed or other devices."""
    device = tensors[0].device
    for t in tensors[1:]:
        if t.device != device:
            raise RuntimeError(f"Expected all tensors to be on the same device, but found {device} and {t.device}")
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel or plain version for tensors on {device}")


def note_launch(name: str, branch: str, shape: Tuple[int, ...], cost_key: Any = None, flops: float = 0.0,
                bytes_accessed: float = 0.0) -> None:
    """Account one launch of kernel ``name``: written down inside a capture,
    else counted, with its cost entry and ``kernel`` event."""
    event_name = EVENT_NAMES.get(name, name)
    if telemetry.telemetry_enabled():
        _note_engaged(event_name)
    recordings = _recordings()
    if recordings:
        recordings[-1].append((name, branch, tuple(shape), float(flops), float(bytes_accessed)))
        return
    _count(name, branch, tuple(shape))
    record_cost(event_name, cost_key, flops, bytes_accessed)


def _recordings() -> List[List[Launch]]:
    stack = getattr(_recording_stack, "lists", None)
    if stack is None:
        stack = _recording_stack.lists = []
    return stack


def _count(name: str, branch: str, shape: Tuple[int, ...]) -> None:
    with _lock:
        _launches[name] += 1
        _by_shape[name][(branch, shape)] = _by_shape[name].get((branch, shape), 0) + 1


@contextmanager
def recording() -> Iterator[List[Launch]]:
    """Write down, and do not count, the launches this thread makes in the
    block (a capture)."""
    launched: List[Launch] = []
    _recordings().append(launched)
    try:
        yield launched
    finally:
        _recordings().remove(launched)


def note_replay(launched: List[Launch]) -> None:
    """Count the launches a replayed graph ran (no cost entry, no event)."""
    for name, branch, shape, _, _ in launched:
        _count(name, branch, shape)
        with _lock:
            _replayed[name] += 1


def launches() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launches`."""
    return dict(_launches)


def replayed_launches() -> Dict[str, int]:
    """The part of :func:`launches` that graph replays ran: the rest each
    fired one ``kernel`` event."""
    return dict(_replayed)


def launches_by_shape(name: str) -> Dict[Tuple[str, Tuple[int, ...]], int]:
    """Launches of kernel ``name`` per ``(branch, shape)`` since the last
    :func:`reset_launches`."""
    return dict(_by_shape[name])


def reset_launches() -> None:
    for name in _launches:
        _launches[name] = 0
        _replayed[name] = 0
        _by_shape[name].clear()


def record_cost(name: str, cost_key: Any, flops: float, bytes_accessed: float) -> None:
    """One analytic ``kernel`` entry and one ``kernel`` event for a launch of
    ``ops.<name>`` (nothing without a ``cost_key`` or with telemetry off).
    Shapes and numbers only: no tensor is read."""
    if cost_key is None or not telemetry.telemetry_enabled():
        return
    entry = cost_model.record_static(f"ops.{name}", "kernel", cost_key, flops=flops, bytes_accessed=bytes_accessed)
    key = (name, repr(cost_key))
    first = key not in _costed
    if first:
        with _lock:
            _costed.add(key)
    # the cost attributes only while a session listens: the counters read none of them
    attrs = cost_model.launch_attrs(entry, None) if telemetry.subscribed() else {}
    telemetry.emit("kernel", f"ops.{name}", "kernel", first=first, **attrs)


def _note_engaged(name: str) -> None:
    owner = getattr(_lowering_owner, "value", None)
    with _lock:
        _engaged_by_owner.setdefault(owner or f"ops.{name}", set()).add(name)


@contextmanager
def lowering(owner: str) -> Iterator[None]:
    """Opened by an engine around a program's build, so that the kernels the
    program runs are attributed to ``owner`` (:func:`engaged`)."""
    prev = getattr(_lowering_owner, "value", None)
    _lowering_owner.value = owner
    try:
        yield
    finally:
        _lowering_owner.value = prev


def engaged(owner: Optional[str] = None) -> Dict[str, Set[str]]:
    """Which kernels ran, keyed by owner (an engine's label, or
    ``ops.<name>`` for a call outside any build), or one owner's set."""
    with _lock:
        if owner is not None:
            return {owner: set(_engaged_by_owner.get(owner, set()))}
        return {k: set(v) for k, v in _engaged_by_owner.items()}


def reset_stats() -> None:
    """Clear the engagement and first-launch bookkeeping."""
    with _lock:
        _engaged_by_owner.clear()
        _costed.clear()


def device_limits(device: torch.device, lib: ctypes.CDLL, name: str) -> Tuple[int, int]:
    """The SM count and the opt-in shared memory a block may use on CUDA
    ``device``, from which the launch plans size their grids; read once
    through the ``<name>_device`` export of the kernel library ``lib``
    (``csrc/device.cuh``)."""
    device = torch.device(device)
    if device not in _limits:
        sms, shared = ctypes.c_int(0), ctypes.c_int(0)
        query = getattr(lib, f"{name}_device")
        query.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        query.restype = ctypes.c_int
        with torch.cuda.device(device):
            err = query(ctypes.byref(sms), ctypes.byref(shared))
        if err != 0:
            message = getattr(lib, f"{name}_error_string")(err).decode()
            raise RuntimeError(f"{name}: cannot read the device's limits: {message}")
        _limits[device] = (sms.value, shared.value)
    return _limits[device]
