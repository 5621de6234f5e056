"""Roofline-attributed cost model: model flops and bytes per program and kernel.

Port of ``metrics_tpu/analysis/cost_model.py``. A process-level registry
holds one :class:`CostEntry` per engine program and per kernel shape, keyed
by a stable 12-hex ``cost_key``. Compile spans carry an entry's static
numbers (:func:`compile_attrs`), and launch spans the utilisation they
imply (:func:`launch_attrs`): model flops and bytes, arithmetic intensity,
the roofline regime and, with a measured duration, achieved GFLOP/s and
GB/s and, on a card in :data:`DEVICE_PEAKS`, ``roofline_frac``.

Where the numbers come from:

* **A kernel launch** (:func:`record_static`, from
  :mod:`metrics_tpu_torch.ops.registry`): each op's analytic terms, the
  bytes its Hopper kernel must move (each input read once, each output
  written once) and the operations it needs, from shapes alone. They are
  the terms of ``chip_smoke.py``'s bound, so a kernel event's
  ``roofline_frac`` and PERF.md's bound column agree.
* **An engine program** (:func:`record`). XLA's ``cost_analysis()`` has no
  counterpart for a captured CUDA graph, so the entry of a dispatcher's
  program is defined here: ``flops`` and ``bytes_accessed`` are the sums of
  the analytic entries of the registry kernels its capture recorded, plus
  its I/O bytes (the program's static inputs, and one set of state leaves
  read and one written); ``arg_bytes`` and ``out_bytes`` are those I/O
  bytes; ``peak_temp_bytes`` is the growth of the bytes allocated on the
  card across the captures (``torch.cuda.memory_stats``), which the graphs'
  memory pool keeps. On the CPU, where there is no graph, the entry is the
  I/O bytes alone.
* **A sync bucket**: the bucket's bytes on the wire, no flops
  (:mod:`metrics_tpu_torch.sync_engine`).

:func:`device_peaks` names the card by ``torch.cuda.get_device_name()``;
on the CPU there is no trustworthy peak and the basis is relative, against
:data:`NOMINAL_RIDGE`.
"""
import hashlib
import threading
from typing import Any, Dict, NamedTuple, Optional, Tuple

__all__ = [
    "CostEntry",
    "record",
    "record_static",
    "lookup",
    "entries",
    "reset",
    "launch_attrs",
    "compile_attrs",
    "device_peaks",
    "classify",
    "NOMINAL_RIDGE",
]

# Arithmetic-intensity ridge (flops/byte) used when no absolute device peak
# is known (CPU runs), as in the JAX package: purely structural, so the same
# program classifies the same way on every host.
NOMINAL_RIDGE = 100.0

# device-name substring -> (peak GFLOP/s, peak GB/s), matched longest first
# against torch.cuda.get_device_name(); "cuda" is the fallback for a card no
# row names. The H100 row is the float32 rate outside the tensor cores and
# the HBM3 rate of NVIDIA's data sheet (SXM part, 700 W): the 67 TFLOP/s and
# 3.35 TB/s behind PERF.md's bound column.
DEVICE_PEAKS: Dict[str, Tuple[float, float]] = {
    "H100": (67000.0, 3350.0),
    "cuda": (30000.0, 2000.0),
}


class CostEntry(NamedTuple):
    """The model cost of one program or kernel launch."""

    owner: str
    family: str          # update / forward / kernel / sync
    key_id: str          # stable 12-hex digest of (owner, family, cache key)
    flops: float         # model flops per launch
    bytes_accessed: float  # HBM bytes moved per launch
    peak_temp_bytes: float  # bytes a captured program's memory pool keeps
    arg_bytes: float
    out_bytes: float
    marks: Tuple[Tuple[str, str], ...] = ()  # a captured program's device phase marks, (owner, phase) in order

    @property
    def intensity(self) -> float:
        """Arithmetic intensity in flops/byte (0 when bytes unknown)."""
        return self.flops / self.bytes_accessed if self.bytes_accessed > 0 else 0.0


_lock = threading.Lock()
_registry: Dict[str, CostEntry] = {}


def _key_id(owner: str, family: str, key: Any) -> str:
    digest = hashlib.md5(repr((owner, family, key)).encode("utf-8", "replace"))
    return digest.hexdigest()[:12]


def record(owner: str, family: str, key: Any, program: Any) -> Optional[CostEntry]:
    """Register the entry of one engine program built under ``key``.

    ``program`` holds ``launched`` (the registry kernels its capture
    recorded, each ``(name, branch, shape, flops, bytes)``), ``arg_bytes``
    and ``out_bytes`` (its static inputs and one state set read; one state
    set written) and ``peak_temp_bytes``, and may hold ``marks`` (its device
    phase marks, :mod:`metrics_tpu_torch.ops.marks`). Returns ``None`` (and
    records nothing) for an object without them.
    """
    try:
        kernels = tuple(program.launched)
        arg_bytes, out_bytes = float(program.arg_bytes), float(program.out_bytes)
        peak_temp = float(program.peak_temp_bytes)
    except (AttributeError, TypeError, ValueError):
        return None
    entry = CostEntry(
        owner=str(owner),
        family=str(family),
        key_id=_key_id(owner, family, key),
        flops=float(sum(k[3] for k in kernels)),
        bytes_accessed=float(sum(k[4] for k in kernels)) + arg_bytes + out_bytes,
        peak_temp_bytes=peak_temp,
        arg_bytes=arg_bytes,
        out_bytes=out_bytes,
        marks=tuple(getattr(program, "marks", ())),
    )
    with _lock:
        _registry[entry.key_id] = entry
    return entry


def record_static(
    owner: str,
    family: str,
    key: Any,
    *,
    flops: float,
    bytes_accessed: float,
    arg_bytes: float = 0.0,
    out_bytes: float = 0.0,
) -> Optional[CostEntry]:
    """Register an analytically-derived entry (no compiled object).

    :mod:`metrics_tpu_torch.ops` derives each kernel's terms from shapes in
    closed form, the same on every backend.
    """
    entry = CostEntry(
        owner=str(owner),
        family=str(family),
        key_id=_key_id(owner, family, key),
        flops=float(flops),
        bytes_accessed=float(bytes_accessed),
        peak_temp_bytes=0.0,
        arg_bytes=float(arg_bytes),
        out_bytes=float(out_bytes),
    )
    with _lock:
        _registry[entry.key_id] = entry
    return entry


def lookup(key_id: str) -> Optional[CostEntry]:
    with _lock:
        return _registry.get(key_id)


def entries() -> Dict[str, CostEntry]:
    """Snapshot of the registry (``key_id -> CostEntry``)."""
    with _lock:
        return dict(_registry)


def reset() -> None:
    with _lock:
        _registry.clear()


# --------------------------------------------------------------- roofline
_peaks_cache: Optional[Tuple[bool, Optional[Tuple[float, float]]]] = None


def device_peaks(refresh: bool = False) -> Optional[Tuple[float, float]]:
    """(peak GFLOP/s, peak GB/s) of the current CUDA card, or ``None`` where
    there is none (the CPU: the relative basis). The longest row of
    :data:`DEVICE_PEAKS` the card's name contains, else the ``cuda`` row.
    Probed once, then cached."""
    global _peaks_cache
    if _peaks_cache is not None and not refresh:
        return _peaks_cache[1]
    peaks: Optional[Tuple[float, float]] = None
    try:
        import torch

        if torch.cuda.is_available():
            kind = torch.cuda.get_device_name().lower()
            best = ""
            for sub, p in DEVICE_PEAKS.items():
                if sub.lower() in kind and len(sub) > len(best):
                    best, peaks = sub, p
            if peaks is None:
                peaks = DEVICE_PEAKS["cuda"]
    except Exception:  # noqa: BLE001 -- an unreadable card is the relative basis, never a failure
        peaks = None
    _peaks_cache = (True, peaks)
    return peaks


def classify(intensity: float, ridge: Optional[float] = None) -> str:
    """Roofline regime for an arithmetic intensity (flops/byte)."""
    if ridge is None:
        peaks = device_peaks()
        ridge = (peaks[0] / peaks[1]) if peaks else NOMINAL_RIDGE
    return "bandwidth-bound" if intensity < ridge else "compute-bound"


def compile_attrs(entry: Optional[CostEntry]) -> Dict[str, Any]:
    """Static cost attrs for the compile span that minted ``entry``."""
    if entry is None:
        return {}
    return {
        "cost_key": entry.key_id,
        "cost_flops": entry.flops,
        "cost_bytes": entry.bytes_accessed,
        "cost_peak_temp_bytes": entry.peak_temp_bytes,
    }


def launch_attrs(entry: Optional[CostEntry], dur_us: Optional[float]) -> Dict[str, Any]:
    """Utilization attrs for one launch of ``entry``'s executable.

    Always carries the structural numbers (``model_flops`` /
    ``model_bytes`` / ``intensity`` / ``regime`` / ``roofline_basis``);
    with a measured ``dur_us`` adds ``achieved_gflops`` /
    ``achieved_gbps`` and — on a device with absolute peaks —
    ``roofline_frac`` (achieved over the roofline ceiling at this
    intensity, whichever of the two walls binds)."""
    if entry is None:
        return {}
    peaks = device_peaks()
    intensity = entry.intensity
    attrs: Dict[str, Any] = {
        "cost_key": entry.key_id,
        "model_flops": entry.flops,
        "model_bytes": entry.bytes_accessed,
        "intensity": round(intensity, 4),
        "regime": classify(intensity),
        "roofline_basis": "absolute" if peaks else "relative",
    }
    if dur_us is not None and dur_us > 0:
        # flops / µs * 1e-3 == GFLOP/s; bytes / µs * 1e-3 == GB/s
        gflops = entry.flops / dur_us * 1e-3
        gbps = entry.bytes_accessed / dur_us * 1e-3
        attrs["achieved_gflops"] = round(gflops, 4)
        attrs["achieved_gbps"] = round(gbps, 4)
        if peaks:
            peak_gflops, peak_gbps = peaks
            # the attainable ceiling at this intensity: min(peak compute,
            # intensity * peak bandwidth) — classic roofline
            ceiling = min(peak_gflops, intensity * peak_gbps) if intensity > 0 else 0.0
            if ceiling > 0:
                attrs["roofline_frac"] = round(gflops / ceiling, 6)
    return attrs
