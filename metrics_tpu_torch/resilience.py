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

* **Collective retry** (``metrics_tpu/resilience.py:364-455``):
  :func:`run_collective` runs each collective of a
  :class:`~metrics_tpu_torch.parallel.ProcessEnv` with bounded retries, and
  on exhaustion degrades that sync to local-only state. A collective's
  deadline is its process group's own timeout (the JAX package's
  ``METRICS_TPU_COLLECTIVE_TIMEOUT_S`` has no counterpart), and a group a
  collective failed in is issued nothing more (:func:`group_broken`).

Every degrade, of an engine, of the sync engine or of a collective, is
counted by :func:`record_degrade` (:func:`degrades`) and emitted as one
cause-tagged ``degrade`` telemetry span with the policy's cooldown
(``metrics_tpu/resilience.py:238, 438, 444``); a collective that succeeds
on a retry emits one with the cause ``recovered``. The checkpoint checksums
are in :mod:`metrics_tpu_torch.utilities.checksums`.

Environment knobs:

=============================== ========================================
``METRICS_TPU_RESILIENCE=0``    permanent demotion on the first failure,
                                no snapshots, no verification
``METRICS_TPU_VERIFY_STATE=1``  verify every engine call, finite values
                                too, with no fault injected (``0``: no
                                value check)
``METRICS_TPU_BACKOFF_BASE``    first cooldown, in calls (default 4)
``METRICS_TPU_BACKOFF_MAX``     longest cooldown, in calls (default 256)
``METRICS_TPU_COLLECTIVE_       attempts after a collective's first one
RETRIES``                       (default 2)
=============================== ========================================
"""
import os
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from metrics_tpu_torch import faults, telemetry
from metrics_tpu_torch.utilities.checksums import attach_checksums, strip_checksums, verify_checksums  # noqa: F401
from metrics_tpu_torch.utilities.exceptions import StateCorruptionError
from metrics_tpu_torch.utilities.prints import rank_zero_debug, rank_zero_warn

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
    "attach_checksums",
    "verify_checksums",
    "strip_checksums",
    "run_collective",
    "group_broken",
    "degrades",
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


def aggregate_policy_stats(stats_list: Any) -> Dict[str, Any]:
    """Fold per-shard :meth:`ResiliencePolicy.stats` dicts into one fleet view
    (:class:`metrics_tpu_torch.fabric.ShardedMetricsService`): counters sum,
    ``cooldown`` is the longest live one, ``permanent`` is true if any shard's
    is, ``last_cause`` the last cause in shard order."""
    out: Dict[str, Any] = {
        "demotions": 0,
        "repromotions": 0,
        "cooldown": 0,
        "permanent": False,
        "last_cause": None,
        "shards": 0,
    }
    for stats in stats_list:
        if not stats:
            continue
        out["shards"] += 1
        out["demotions"] += int(stats.get("demotions", 0))
        out["repromotions"] += int(stats.get("repromotions", 0))
        out["cooldown"] = max(out["cooldown"], int(stats.get("cooldown", 0)))
        out["permanent"] = out["permanent"] or bool(stats.get("permanent", False))
        if stats.get("last_cause") is not None:
            out["last_cause"] = stats["last_cause"]
    return out


def classify(err: BaseException) -> str:
    """The cause tag of an engine failure."""
    if isinstance(err, faults.InjectedFault):
        return f"injected:{err.fault_name}"
    if isinstance(err, StateCorruptionError):
        return "state-corruption"
    if type(err).__name__ == "FastDispatchUnsupported":  # by name: dispatch imports this module
        return "unsupported"
    return type(err).__name__


# degrades counted by engine kind since the process started: like the kernels' launch counts, a process-wide
# tally a run reads at its end
_degrades: Dict[str, int] = {}


def record_degrade(owner: str, engine: str, err: BaseException, policy: Optional[ResiliencePolicy] = None,
                   **attrs: Any) -> str:
    """Account one failure of ``owner``'s ``engine``: count it under
    ``engine`` (:func:`degrades`), emit its ``degrade`` span (kind
    ``engine``, the cause, the error, ``attrs``) and log it at debug level;
    returns the cause tag. With a ``policy`` the engine is benched (for good
    where the input is unsupported) and the span carries its ``cooldown``,
    ``permanent`` and ``failures``."""
    cause = classify(err)
    _degrades[engine] = _degrades.get(engine, 0) + 1
    if policy is None:
        telemetry.emit("degrade", owner, kind=engine, cause=cause, error=str(err)[:200], **attrs)
        rank_zero_debug(f"{engine} of {owner} degraded ({type(err).__name__}: {err})")
        return cause
    policy.note_failure(cause, permanent=cause == "unsupported")
    telemetry.emit("degrade", owner, kind=engine, cause=cause, error=str(err)[:200], cooldown=policy.cooldown,
                   permanent=policy.permanent, failures=policy.failures, **attrs)
    rank_zero_debug(
        f"{engine} engine of {owner} degraded ({type(err).__name__}: {err}); the eager path serves the call"
        + (" from now on." if policy.permanent else f" (cooldown {policy.cooldown} calls).")
    )
    return cause


def degrades() -> Dict[str, int]:
    """Degrades counted so far, by engine (``dispatch``, ``forward``,
    ``sync``, ``quant-sync``, ``shard-sync``, ``collective``, ...)."""
    return dict(_degrades)


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


# ------------------------------------------------------------ collective retry
def _collective_retries() -> int:
    try:
        return max(0, int(os.environ.get("METRICS_TPU_COLLECTIVE_RETRIES", "2")))
    except ValueError:
        return 2


class CollectiveIssued(RuntimeError):
    """A collective failed after it reached the backend (past the group's
    timeout, a peer gone): it cannot be tried again."""


# Process groups a collective failed in, by id (the group is held, so its id is not reused). None is the default
# group. A failed collective leaves the group's sequence out of step between ranks, so none is issued on it again.
_BROKEN_GROUPS: Dict[int, Any] = {}


def _group_key(group: Any) -> Any:
    return dist.group.WORLD if group is None else group


def group_broken(group: Any = None) -> bool:
    """Whether a collective on ``group`` (None: the default group) failed
    inside the backend in this process: every later collective on it is
    served locally, and only a new group (``torch.distributed.new_group``)
    syncs again."""
    return id(_group_key(group)) in _BROKEN_GROUPS


def _call_with_timeout(fn: Callable[[], Any], desc: str) -> Any:
    """One attempt of a collective, under the process group's own timeout.

    A ``torch.distributed`` collective that passed a deadline cannot be
    abandoned safely: its buffers stay with the backend and the peers'
    matching calls stay pending, so the next call on the group would pair
    with a peer's other collective. So no thread watches the attempt (the
    JAX package's way) and the port has no ``METRICS_TPU_COLLECTIVE_TIMEOUT_S``:
    the deadline is the group's ``timeout`` (``init_process_group(timeout=)``,
    ``new_group(timeout=)``), which the backend enforces. A failure past
    that point is raised as :class:`CollectiveIssued`, which
    :func:`run_collective` does not retry."""
    try:
        return fn()
    except RuntimeError as err:
        if isinstance(err, faults.InjectedFault):
            raise
        raise CollectiveIssued(f"collective '{desc}' failed in the backend: {err}") from err


def run_collective(
    attempt: Callable[[], Any],
    fallback: Callable[[], Any],
    owner: str,
    desc: str,
    group: Any = None,
) -> Any:
    """Bounded retries for one collective of a ``ProcessEnv`` over ``group``
    (None: the default group).

    ``attempt()`` runs up to ``1 + METRICS_TPU_COLLECTIVE_RETRIES`` times,
    each probing the ``collective`` fault point first, so tests reach both
    the retry that succeeds and the exhausted path. A failure before the
    collective reached the backend is retried; one inside it
    (:class:`CollectiveIssued`) is not (see :func:`_call_with_timeout`), and
    marks ``group`` broken: this and every later collective on it are served
    by ``fallback`` without being issued (:func:`group_broken`). On
    exhaustion the degrade is counted (:func:`degrades`, kind
    ``collective``), a warning is given, and ``fallback`` (local-only,
    world-size-1 semantics) serves the call: partial data rather than a hang,
    and the state stays valid for a later sync."""
    key = _group_key(group)
    if id(key) in _BROKEN_GROUPS:
        record_degrade(owner, "collective", CollectiveIssued(f"collective '{desc}' not issued: its group is broken"),
                       retries=0, op=desc, local_only=True)
        return fallback()
    retries = _collective_retries() if resilience_enabled() else 0
    last_err: Optional[BaseException] = None
    for attempt_idx in range(1 + retries):

        def guarded() -> Any:
            faults.check("collective", desc)
            return attempt()

        try:
            result = _call_with_timeout(guarded, desc)
            if attempt_idx:
                telemetry.emit("degrade", owner, kind="collective", cause="recovered", retries=attempt_idx, op=desc)
            return result
        except CollectiveIssued as err:
            last_err = err
            _BROKEN_GROUPS[id(key)] = key
            break
        except Exception as err:  # noqa: BLE001 -- retried, then degraded; never a hang or a crash of the sync
            last_err = err
    cause = record_degrade(owner, "collective", last_err, retries=retries, op=desc, local_only=True)
    rank_zero_warn(
        f"collective '{desc}' failed ({cause}: {last_err}); degrading to local-only state for this sync:"
        " cross-process results reflect this process only until a later sync succeeds"
        + (" on a new process group: this one issues no further collective" if group_broken(group) else "")
    )
    return fallback()
