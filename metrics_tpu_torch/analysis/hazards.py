"""Predicted retrace hazards, read from the checked-in static audit.

Port of ``metrics_tpu/analysis/hazards.py``. The port's static audit
(:mod:`~metrics_tpu_torch.analysis.program_audit`) derives, per metric,
whether its update signature makes a rebuild cause structurally likely
(``static-key``: flag-like update parameters; ``signature``: a state leaf
whose shape or dtype the update does not keep) and records it in the
port's own baseline, ``STATIC_AUDIT_TORCH.json`` at the repository root
(``tools/torch_static_audit.py --write-baseline``). The JAX package's
``STATIC_AUDIT.json`` holds the JAX programs' hazards and is never read
here. ``METRICS_TPU_STATIC_AUDIT`` names another path. When a ``compile``
span fires with a mapped cause, the dispatcher attaches
``predicted=<bool>`` so ``tools/torch_trace_report.py`` can show predicted
against observed rebuilds.

Standard library only: the dispatcher imports it at module load.
"""
import json
import os
import threading
from typing import Any, Dict, Optional

# compile-span cause -> hazard class the auditor predicts
CAUSE_TO_HAZARD = {
    "new-static-key": "static-key",
    "new-signature": "signature",
    "new-input-signature": "signature",
}

BASELINE_NAME = "STATIC_AUDIT_TORCH.json"
_BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", BASELINE_NAME)

_lock = threading.Lock()
_cache: Optional[Dict[str, Dict[str, bool]]] = None
_cache_path: Optional[str] = None


def baseline_path() -> str:
    """Path of the port's checked-in audit baseline (``STATIC_AUDIT_TORCH.json``
    at the repo root; override with ``METRICS_TPU_STATIC_AUDIT``)."""
    return os.environ.get("METRICS_TPU_STATIC_AUDIT", os.path.normpath(_BASELINE_PATH))


def _load() -> Dict[str, Dict[str, bool]]:
    global _cache, _cache_path
    path = baseline_path()
    with _lock:
        if _cache is not None and _cache_path == path:
            return _cache
        table: Dict[str, Dict[str, bool]] = {}
        try:
            with open(path) as f:
                data = json.load(f)
            for owner, haz in (data.get("hazards") or {}).items():
                if isinstance(haz, dict):
                    table[owner] = {k: bool(v) for k, v in haz.items()}
        except (OSError, ValueError):
            pass  # no baseline -> no predictions; never fail the hot path
        _cache, _cache_path = table, path
        return table


def invalidate() -> None:
    """Drop the cached table (tests / freshly rewritten baselines)."""
    global _cache
    with _lock:
        _cache = None


def predicted(owner: str, cause: str) -> Optional[Any]:
    """Did the auditor predict this owner would compile for this cause?

    Returns ``True``/``False`` for the mapped hazard causes (missing
    owners — collections, unaudited custom metrics — read as ``False``)
    and ``None`` for causes the auditor does not model (first-compile,
    shape buckets, dtypes, persistent-cache hits): callers skip the
    attr entirely then.
    """
    hazard = CAUSE_TO_HAZARD.get(cause)
    if hazard is None:
        return None
    return bool(_load().get(owner, {}).get(hazard, False))
