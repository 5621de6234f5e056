"""Fault injection at the engines' seams: port of the engine- and
sync-facing part of ``metrics_tpu/faults.py`` (its lines 18-60 and 159-338).

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
                          bucket crosses at full precision instead)
``nan-input``             the program's float inputs are replaced by NaN
                          (caught by the state verification that runs
                          while a fault is active)
``state-corruption``      one state leaf the program wrote is replaced
                          by a wrong-shape tensor (caught by structural
                          verification)
``oom``                   a call whose input bytes exceed the fault's
                          ``cap`` (default 0) raises
========================= ==============================================

A fault is active inside :func:`inject` or, process-wide, through
``METRICS_TPU_INJECT_FAULT=<name>[:<probability>]``. The JAX package's crash
points (the write-ahead log, the serving fabric) and ``corrupt_payload`` come
with the serving stack (ROADMAP.md, Queue A item 11).
"""
import os
import random
import threading
from contextlib import contextmanager
from typing import Any, Generator, List, Optional, Tuple

import torch

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
