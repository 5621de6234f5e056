"""Fault injection at the engines', the serving stack's and the fabric's
seams: port of ``metrics_tpu/faults.py``.

A test activates a named fault, and the engines (:mod:`metrics_tpu_torch.dispatch`
and the forward and collection paths built on it, the sync engine and the
``ProcessEnv`` collectives) probe for it where they can fail, so that the real
recovery path runs: the same snapshot, restore and degrade code that a genuine
capture error, a failed launch or a failed collective takes.

========================= ==============================================
fault name                where it fires
========================= ==============================================
``compile``               while the engine builds a program (on the card:
                          its warm-up run and CUDA-graph capture)
``launch``                just before a program runs (a graph replay)
``collective``            inside a ``ProcessEnv`` collective's attempt,
                          before it reaches the backend (so the retry and
                          the local-only degrade are both reachable)
``quant-corruption``      a quantised sync bucket's codec raises (the
                          bucket crosses at full precision instead), and
                          a replication seed frame is bit-garbled before
                          decode (its crc turns that into
                          ``StateCorruptionError``)
``nan-input``             the program's float inputs are replaced by NaN
                          (caught by the state verification that runs
                          while a fault is active)
``state-corruption``      one state leaf the program wrote is replaced
                          by a wrong-shape tensor (caught by structural
                          verification)
``oom``                   a call whose input bytes exceed the fault's
                          ``cap`` (default 0) raises
``clock-skew``            the wall clock steps back under the journal's
                          appender (param ``skew_s``, default 3600): the
                          ``ts`` headers go non-monotonic; nothing raises,
                          and every reader orders by ``seq``
``shard-death``           a fabric shard stops answering its liveness probe
                          (:mod:`metrics_tpu_torch.fabric`; param ``shard``,
                          default any): the next route, probe or fleet read
                          touching it marks it dead, and the fabric fences
                          its journal and replays it on a peer
``shard-slow``            gray failure: every flush of the targeted shard
                          that found work sleeps ``ms`` (default 25) first
                          (params ``shard``, ``ms``); nothing raises, and
                          the suspicion sweep must quarantine it
``network-partition``     the targeted shard (param ``shard``) is
                          unreachable from the router while its host runs
                          on: the fabric fences and fails it over, after
                          which the old side's journaled writes raise
                          ``StaleEpochError``
``history-corruption``    a checkpoint-ladder rung is born bit-flipped on
                          disk (a copy, so the head stays intact):
                          ``scrub()`` quarantines it, and recovery and
                          ``compute_at`` fall back to the newest verified
                          rung
========================= ==============================================

A fault is active inside :func:`inject` or, process-wide, through
``METRICS_TPU_INJECT_FAULT=<name>[:<probability>]``.

Crash points (:data:`CRASH_POINTS`) kill the process with SIGKILL at one
instruction of the serving stack, as a preemption or the OOM killer would:
armed by :func:`crash` or ``METRICS_TPU_CRASH=<point>[:<nth>]``, the
``nth`` probe of the point fires.

The JAX package's ``cache-corruption`` class fires in its persistent program
cache (``metrics_tpu/aot_cache.py``), which the port does not have: a CUDA
graph cannot be serialized across processes, and the one compile the port
persists, ``nvcc``'s, is keyed by a digest of its sources and written with an
atomic rename (:mod:`metrics_tpu_torch.ops._build`).
"""
import os
import random
import signal
import threading
import zlib
from contextlib import contextmanager
from typing import Any, Dict, Generator, List, Optional, Tuple

import torch

# the fault classes the port probes: the JAX package's (metrics_tpu/faults.py:140-154) less cache-corruption
FAULT_NAMES = (
    "compile",
    "launch",
    "collective",
    "nan-input",
    "state-corruption",
    "oom",
    "shard-death",
    "shard-slow",
    "network-partition",
    "quant-corruption",
    "history-corruption",
    "clock-skew",
)

_ENV_VAR = "METRICS_TPU_INJECT_FAULT"


class InjectedFault(RuntimeError):
    """Raised at an injection point when the named fault is active."""

    def __init__(self, name: str, where: str = "") -> None:
        self.fault_name = name
        super().__init__(f"injected fault: {name}" + (f" (at {where})" if where else ""))


class _FaultSpec:
    """One active fault: its name, fire probability, remaining fires (a
    transient fault goes inert at zero), fires so far and free-form params
    (``cap`` bytes for ``oom``, ``leaf`` index for ``state-corruption``)."""

    __slots__ = ("name", "prob", "count", "fired", "params")

    def __init__(self, name: str, prob: float = 1.0, count: Optional[int] = None, **params: Any) -> None:
        self.name = name
        self.prob = float(prob)
        self.count = count
        self.fired = 0
        self.params = params

    def take(self) -> bool:
        """Decide one probe: fire (and use up one count) or not."""
        if self.count is not None and self.count <= 0:
            return False
        if self.prob < 1.0 and random.random() >= self.prob:
            return False
        if self.count is not None:
            self.count -= 1
        self.fired += 1
        return True


_lock = threading.Lock()
# the specs of the active inject() blocks, innermost last
_specs: List[_FaultSpec] = []
# (the variable's text, its parsed spec): parsed once a value
_env_cache: Tuple[Optional[str], Optional[_FaultSpec]] = (None, None)


def _env_spec() -> Optional[_FaultSpec]:
    global _env_cache
    raw = os.environ.get(_ENV_VAR)
    if not raw:
        return None
    cached_raw, cached_spec = _env_cache
    if raw == cached_raw:
        return cached_spec
    name, _, prob = raw.partition(":")
    try:
        spec = _FaultSpec(name.strip(), float(prob) if prob else 1.0)
    except ValueError:
        spec = _FaultSpec(name.strip(), 1.0)
    with _lock:
        _env_cache = (raw, spec)
    return spec


def _lookup(name: str) -> Optional[_FaultSpec]:
    # the innermost inject() block wins over the environment variable
    for spec in reversed(_specs):
        if spec.name == name:
            return spec
    env = _env_spec()
    return env if env is not None and env.name == name else None


@contextmanager
def inject(
    name: str, prob: float = 1.0, count: Optional[int] = None, **params: Any
) -> Generator[_FaultSpec, None, None]:
    """Activate fault ``name`` for the block; ``count=N`` fires it N times,
    then it goes inert (``.fired`` stays readable)."""
    spec = _FaultSpec(name, prob=prob, count=count, **params)
    with _lock:
        _specs.append(spec)
    try:
        yield spec
    finally:
        with _lock:
            _specs.remove(spec)


def any_active() -> bool:
    """Whether any fault is injected; the costly state checks run only then."""
    return bool(_specs) or _env_spec() is not None


def should_fire(name: str) -> bool:
    """Non-raising probe: use up one fire of ``name`` if it is active."""
    if not _specs and _ENV_VAR not in os.environ:
        return False
    spec = _lookup(name)
    return spec is not None and spec.take()


def check(name: str, where: str = "") -> None:
    """Raising probe: raise :class:`InjectedFault` if ``name`` fires."""
    if should_fire(name):
        raise InjectedFault(name, where)


def fault_params(name: str) -> Dict[str, Any]:
    """The params of the innermost active spec for ``name`` (empty when
    inactive), read without using up a fire."""
    spec = _lookup(name)
    return dict(spec.params) if spec is not None else {}


def fired_count(name: str) -> int:
    """How often ``name`` fired across the active specs (for tests)."""
    total = sum(s.fired for s in _specs if s.name == name)
    env = _env_spec()
    if env is not None and env.name == name:
        total += env.fired
    return total


def check_oom(nbytes: int, where: str = "") -> None:
    """Raise where an active ``oom`` fault's byte cap (param ``cap``, default
    0: every call) is below ``nbytes``."""
    if not _specs and _ENV_VAR not in os.environ:
        return
    spec = _lookup("oom")
    if spec is None:
        return
    cap = int(spec.params.get("cap", 0))
    if nbytes > cap and spec.take():
        raise InjectedFault("oom", where or f"payload {nbytes}B > cap {cap}B")


def maybe_poison(tensors: List[Any]) -> List[Any]:
    """When ``nan-input`` fires, every float tensor of ``tensors`` is replaced
    by NaNs of its shape; silent, for the state verification to catch."""
    if not _specs and _ENV_VAR not in os.environ:
        return tensors
    if not should_fire("nan-input"):
        return tensors
    return [torch.full_like(x, float("nan")) if isinstance(x, torch.Tensor) and x.is_floating_point() else x
            for x in tensors]


def maybe_corrupt_leaves(leaves: Tuple) -> Tuple:
    """When ``state-corruption`` fires, one leaf (param ``leaf``, default 0)
    is replaced by a (3, 7) float32 tensor of -1: a wrong shape, for the
    structural state verification to catch."""
    if not _specs and _ENV_VAR not in os.environ:
        return leaves
    if not leaves or not should_fire("state-corruption"):
        return leaves
    spec = _lookup("state-corruption")
    idx = int(spec.params.get("leaf", 0)) % len(leaves) if spec is not None else 0
    out = list(leaves)
    out[idx] = torch.full((3, 7), -1.0, dtype=torch.float32, device=leaves[idx].device)
    return tuple(out)


def corrupt_payload(payload: Dict[str, Any], key: Optional[str] = None) -> Dict[str, Any]:
    """Flip the first four bytes of one array entry of a checkpoint payload
    (``key``, else the first array entry that is not a checksum): its shape
    and dtype survive, its checksum does not."""
    import numpy as np

    keys = [k for k, v in payload.items() if hasattr(v, "dtype") and not str(k).startswith("__checksum__")]
    if not keys:
        return payload
    target = key if key in payload else keys[0]
    value = payload[target]
    arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
    raw = bytearray(arr.tobytes())
    for i in range(min(4, len(raw))):
        raw[i] ^= 0xFF
    payload[target] = np.frombuffer(bytes(raw), dtype=arr.dtype).reshape(arr.shape)
    return payload


def crc(data: bytes, seed: int = 0) -> int:
    """crc32 of ``data`` as an unsigned int (journal frames, checksums)."""
    return zlib.crc32(data, seed) & 0xFFFFFFFF


# ------------------------------------------------------------- crash points
# A fired probe SIGKILLs the process: no exception, no `finally`, no `atexit`.
CRASH_POINTS = (
    "post-journal",        # serve.submit: the record journaled, the request not yet queued
    "mid-journal-append",  # wal.append: half a frame written (a torn tail)
    "mid-flush",           # serve.flush: some waves launched, the rest pending
    "mid-checkpoint",      # serve.checkpoint: the payload written, not renamed
    "mid-truncate",        # wal.truncate: some retired segments unlinked
    "mid-history-gc",      # serve.checkpoint: some expired ladder rungs unlinked
)

_CRASH_ENV = "METRICS_TPU_CRASH"

# the armed point: [name, probes left before it fires]
_crash_spec: Optional[List[Any]] = None
_crash_env_cache: Tuple[Optional[str], Optional[List[Any]]] = (None, None)


def crash(after: str, nth: int = 1) -> None:
    """Arm crash point ``after`` process-wide: its ``nth`` probe SIGKILLs
    the process (``METRICS_TPU_CRASH=<point>[:<nth>]`` does the same).
    ``nth=0`` disarms."""
    global _crash_spec
    if after not in CRASH_POINTS:
        raise ValueError(f"unknown crash point {after!r}; choose from {CRASH_POINTS}")
    with _lock:
        _crash_spec = None if nth <= 0 else [after, int(nth)]


def _crash_lookup() -> Optional[List[Any]]:
    if _crash_spec is not None:
        return _crash_spec
    raw = os.environ.get(_CRASH_ENV)
    if not raw:
        return None
    global _crash_env_cache
    cached_raw, cached = _crash_env_cache
    if raw == cached_raw:
        return cached
    name, _, nth = raw.partition(":")
    name = name.strip()
    spec: Optional[List[Any]] = None
    if name in CRASH_POINTS:
        try:
            spec = [name, int(nth) if nth else 1]
        except ValueError:
            spec = [name, 1]
    with _lock:
        _crash_env_cache = (raw, spec)
    return spec


def crash_armed(name: str) -> bool:
    """Whether crash point ``name`` is armed."""
    if _crash_spec is None and _CRASH_ENV not in os.environ:
        return False
    spec = _crash_lookup()
    return spec is not None and spec[0] == name and spec[1] > 0


def crash_will_fire(name: str) -> bool:
    """Whether the next probe of ``name`` kills the process, without using
    the probe up (``wal.append`` writes half a frame first)."""
    if _crash_spec is None and _CRASH_ENV not in os.environ:
        return False
    spec = _crash_lookup()
    return spec is not None and spec[0] == name and spec[1] == 1


def crash_point(name: str, where: str = "") -> None:
    """Probe crash point ``name``: use up one probe, and at zero SIGKILL
    this process (never returns)."""
    if _crash_spec is None and _CRASH_ENV not in os.environ:
        return
    spec = _crash_lookup()
    if spec is None or spec[0] != name or spec[1] <= 0:
        return
    with _lock:
        spec[1] -= 1
        fire = spec[1] == 0
    if fire:
        os.kill(os.getpid(), signal.SIGKILL)
