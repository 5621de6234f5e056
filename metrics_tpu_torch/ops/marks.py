"""Device phase marks: named no-op kernels inside an engine's captured programs.

A CUDA graph replays as one launch, so a device trace of it shows kernels and
not whose they are. While the engine captures a program
(:meth:`metrics_tpu_torch.dispatch.FastDispatcher._build`), and telemetry is on,
the program launches one of ``csrc/phase_mark.cu``'s five empty kernels at each
phase boundary, in graph order:

* ``format``: the start of each member's update body (``Metric.pure_update``,
  ``Metric._masked_pure_update``), owned by the member's class name;
* ``extract``: where the bundled InceptionV3 extractor calls its trunk, after
  the images' cast, resize and normalisation (FID, KID, IS), owned by the
  member whose ``format`` mark came last;
* ``count``: where that member's inputs leave formatting (or its features
  the trunk), at the call into counting (``confusion_matrix_counts`` or the
  bincount, the stat-score reductions, FID's moment sums), owned by the
  member whose ``format`` mark came last;
* ``writeback``: just before the engine's ``_foreach_copy_`` of the new state
  into the other buffer set;
* ``end``: the end of the captured body.

A linear capture replays in order on one stream, so a phase's device time is
the time from the end of its mark to the start of the next one. The kernel's
symbol alone names the phase (``phase_mark_<phase>``). The capture writes the
marks down as ``(owner, phase)`` pairs (:func:`recording`); the engine keeps
them with the program, in its ``compile`` span (``marks``) and its cost entry,
so the k-th mark of a replay maps to its member.

Marks are placed only inside :func:`recording` on a CUDA device while the
stream captures: eager calls, CPU runs and the engine's warm-up run launch
none, and ``METRICS_TPU_TELEMETRY=0`` captures graphs without them.
"""
import ctypes
import functools
import threading
from contextlib import contextmanager
from typing import Iterator, List, Optional, Tuple

import torch

from metrics_tpu_torch import telemetry
from metrics_tpu_torch.ops import _build

PHASES = ("format", "count", "writeback", "end", "extract")  # the kernels' indices in csrc/phase_mark.cu
_LIB = "phase_mark"

_local = threading.local()


class _Recording:
    __slots__ = ("device", "marks", "owner")

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.marks: List[Tuple[str, str]] = []
        self.owner = ""  # the member whose format mark came last


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    lib.phase_mark_prime.argtypes = []
    lib.phase_mark_prime.restype = ctypes.c_int
    lib.phase_mark_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.phase_mark_launch.restype = ctypes.c_int
    lib.phase_mark_error_string.argtypes = [ctypes.c_int]
    lib.phase_mark_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"phase mark {what} failed: {lib.phase_mark_error_string(err).decode()}")


@contextmanager
def recording(device: torch.device) -> Iterator[List[Tuple[str, str]]]:
    """Mark the program captured inside the block on CUDA ``device``; yields
    the ``(owner, phase)`` list its marks are written to, in launch order. With
    telemetry off, or off CUDA, the block places no mark and the list stays
    empty. Enter it before the capture begins: it loads the kernels first."""
    if not telemetry.telemetry_enabled() or torch.device(device).type != "cuda":
        yield []
        return
    lib = _lib()
    with torch.cuda.device(device):
        _check(lib, lib.phase_mark_prime(), "prime")
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    rec = _Recording(torch.device(device))
    stack.append(rec)
    try:
        yield rec.marks
    finally:
        stack.remove(rec)


def mark(phase: str, owner: Optional[str] = None) -> None:
    """Launch the ``phase`` mark on the capturing stream, owned by ``owner``
    (by default the member whose ``format`` mark came last); outside a
    :func:`recording` capture, nothing."""
    stack = getattr(_local, "stack", None)
    if not stack:
        return
    rec = stack[-1]
    if not torch.cuda.is_current_stream_capturing():
        return
    if phase == "format":
        rec.owner = owner or ""
    lib = _lib()
    stream = torch.cuda.current_stream(rec.device).cuda_stream
    _check(lib, lib.phase_mark_launch(PHASES.index(phase), stream), "launch")
    rec.marks.append((owner or rec.owner, phase))

