"""One degradation policy for every engine, and verified state recovery.

Port of ``metrics_tpu/resilience.py:75-306``:

* **Graceful degradation.** Every engine call site holds a
  :class:`ResiliencePolicy`. On a failure the call is served by the eager
  path (which still runs the kernels on the card), and the engine is benched
  for an exponential-backoff cooldown (``base * 2^(failures-1)`` calls,
  capped); a success after it re-promotes. An input the engine cannot serve
  at all (``FastDispatchUnsupported``) benches it for good.
* **Verified state recovery.** A call snapshots the state leaves first and
  restores them on a fault. The snapshot holds the leaves by reference and
  copies nothing: on the CPU the engine writes no tensor in place, and on the
  card a call never writes the buffers its input leaves are (the engine's
  two buffer sets take turns, :mod:`metrics_tpu_torch.dispatch`). While a
  fault is injected or ``METRICS_TPU_VERIFY_STATE=1`` the leaves are checked
  after the call for shape and dtype, and for finite values unless
  ``METRICS_TPU_VERIFY_STATE=0``. With neither, the dispatcher's own layout
  check when it builds a program is the one check: a replay cannot change a
  buffer's shape or dtype.

The checkpoint checksums are in :mod:`metrics_tpu_torch.utilities.checksums`;
the collective retry (``run_collective``) comes with distributed sync
(ROADMAP.md, Queue A item 5), and the ``degrade`` telemetry span with
observability (item 10): :func:`record_degrade` updates the policy's counters.

Environment knobs:

=============================== ========================================
``METRICS_TPU_RESILIENCE=0``    permanent demotion on the first failure,
                                no snapshots, no verification
``METRICS_TPU_VERIFY_STATE=1``  verify every engine call, finite values
                                too, with no fault injected (``0``: no
                                value check)
``METRICS_TPU_BACKOFF_BASE``    first cooldown, in calls (default 4)
``METRICS_TPU_BACKOFF_MAX``     longest cooldown, in calls (default 256)
=============================== ========================================
"""
import os
from typing import Any, Dict, Optional, Tuple

import torch

from metrics_tpu_torch import faults
from metrics_tpu_torch.utilities.exceptions import StateCorruptionError
from metrics_tpu_torch.utilities.prints import rank_zero_debug

__all__ = [
    "StateCorruptionError",
    "ResiliencePolicy",
    "resilience_enabled",
    "verification_enabled",
    "verify_after_call",
    "classify",
    "record_degrade",
    "snapshot_state",
    "restore_state",
    "verify_engine_state",
]


def resilience_enabled() -> bool:
    """Kill switch (env ``METRICS_TPU_RESILIENCE``, default on)."""
    return os.environ.get("METRICS_TPU_RESILIENCE", "1").strip().lower() not in ("0", "false", "off")


def verification_enabled() -> bool:
    """Finite-value checks: forced by ``METRICS_TPU_VERIFY_STATE=1``, off with
    ``=0``, else on exactly while a fault is injected."""
    raw = os.environ.get("METRICS_TPU_VERIFY_STATE")
    if raw is not None:
        return raw.strip().lower() not in ("0", "false", "off", "")
    return faults.any_active()


def verify_after_call() -> bool:
    """Whether an engine call's leaves are checked afterwards
    (:func:`verify_engine_state`): while a fault is injected, or with
    ``METRICS_TPU_VERIFY_STATE=1``."""
    return faults.any_active() or verification_enabled()


def _env_int(name: str, default: int) -> int:
    try:
        return max(1, int(os.environ.get(name, str(default))))
    except ValueError:
        return default


class ResiliencePolicy:
    """One owner's degradation state machine. Its unit of time is an
    engine-eligible call: while ``cooldown > 0`` each :meth:`allow` counts it
    down and sends the call to the eager path. Plain attributes only, so it
    pickles with its metric."""

    __slots__ = ("failures", "cooldown", "demotions", "repromotions", "last_cause", "permanent")

    def __init__(self) -> None:
        self.failures = 0
        self.cooldown = 0
        self.demotions = 0
        self.repromotions = 0
        self.last_cause: Optional[str] = None
        self.permanent = False

    def allow(self) -> bool:
        """May this call use the engine? ``False`` uses up one cooldown call."""
        if self.permanent:
            return False
        if self.cooldown > 0:
            self.cooldown -= 1
            return False
        return True

    @property
    def blocked(self) -> bool:
        """:meth:`allow` without its side effect."""
        return self.permanent or self.cooldown > 0

    def note_failure(self, cause: str, permanent: bool = False) -> int:
        """Record one engine failure; returns the new cooldown."""
        self.failures += 1
        self.demotions += 1
        self.last_cause = cause
        if permanent or not resilience_enabled():
            self.permanent = True
            self.cooldown = 0
            return 0
        self.cooldown = min(_env_int("METRICS_TPU_BACKOFF_BASE", 4) << (self.failures - 1),
                            _env_int("METRICS_TPU_BACKOFF_MAX", 256))
        return self.cooldown

    def note_success(self) -> None:
        """An engine call (and its verification) succeeded: after a failure
        streak that is a re-promotion."""
        if self.failures:
            self.repromotions += 1
        self.failures = 0
        self.cooldown = 0

    def stats(self) -> Dict[str, Any]:
        return {
            "demotions": self.demotions,
            "repromotions": self.repromotions,
            "cooldown": self.cooldown,
            "permanent": self.permanent,
            "last_cause": self.last_cause,
        }


def classify(err: BaseException) -> str:
    """The cause tag of an engine failure."""
    if isinstance(err, faults.InjectedFault):
        return f"injected:{err.fault_name}"
    if isinstance(err, StateCorruptionError):
        return "state-corruption"
    if type(err).__name__ == "FastDispatchUnsupported":  # by name: dispatch imports this module
        return "unsupported"
    return type(err).__name__


def record_degrade(owner: str, engine: str, err: BaseException, policy: ResiliencePolicy) -> str:
    """Account one failure of ``owner``'s ``engine``: ``policy`` benches the
    engine (for good where the input is unsupported) and the demotion is
    logged at debug level; returns the cause tag. The JAX package's
    ``degrade`` telemetry span waits for ROADMAP.md, Queue A item 10."""
    cause = classify(err)
    policy.note_failure(cause, permanent=cause == "unsupported")
    rank_zero_debug(
        f"{engine} engine of {owner} degraded ({type(err).__name__}: {err}); the eager path serves the call"
        + (" from now on." if policy.permanent else f" (cooldown {policy.cooldown} calls).")
    )
    return cause


def _tensor_leaf_names(metric: Any) -> Tuple[str, ...]:
    return tuple(k for k in metric._defaults if isinstance(getattr(metric, k), torch.Tensor))


def snapshot_state(metric: Any, counters: bool = True) -> Dict[str, Any]:
    """A snapshot of ``metric``'s tensor leaves, by reference, taken before an
    engine call; with ``counters`` also its update count and memoised value."""
    snap: Dict[str, Any] = {"leaves": {name: getattr(metric, name) for name in _tensor_leaf_names(metric)}}
    if counters:
        snap["update_count"] = metric._update_count
        snap["computed"] = metric._computed
    return snap


def restore_state(metric: Any, snap: Dict[str, Any]) -> None:
    """Roll ``metric`` back to a :func:`snapshot_state` snapshot."""
    for name, leaf in snap["leaves"].items():
        object.__setattr__(metric, name, leaf)
    if "update_count" in snap:
        metric._update_count = snap["update_count"]
        metric._computed = snap["computed"]


def verify_engine_state(metric: Any, snap: Dict[str, Any], where: str = "",
                        check_values: Optional[bool] = None) -> None:
    """Check the leaves an engine call left against the snapshot: shape and
    dtype always, finite values while :func:`verification_enabled` (a read of
    the device; ``check_values`` decides it for a caller that asked once for
    many metrics). Raises :class:`StateCorruptionError`."""
    if check_values is None:
        check_values = verification_enabled()
    at = f" at {where}" if where else ""
    for name, before in snap["leaves"].items():
        after = getattr(metric, name)
        if not isinstance(after, torch.Tensor) or after.shape != before.shape or after.dtype != before.dtype:
            raise StateCorruptionError(
                f"engine call left state leaf '{name}' with shape {tuple(getattr(after, 'shape', ()))} "
                f"dtype {getattr(after, 'dtype', '?')} (expected {tuple(before.shape)} {before.dtype}){at}"
            )
        if check_values and after.is_floating_point() and not bool(torch.isfinite(after).all()):
            raise StateCorruptionError(f"engine call left non-finite values in state leaf '{name}'{at}")
