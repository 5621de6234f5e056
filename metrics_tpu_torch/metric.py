"""The ``Metric`` base class: the core of ``metrics_tpu/metric.py`` in PyTorch.

What is ported: ``add_state`` with the named reductions and 32-bit count
states, the ``update``/``compute`` wrappers (memoised compute, update count,
state version), ``forward`` (one update per step when states merge, the
double-update form otherwise), ``reset``, the pure ``(state, batch) -> state``
functions, ``state_dict``/``load_state_dict`` with the JAX package's crc32
checksum entries, and ``to(device)``, which also moves the tensor attributes a
subclass names in ``_device_attributes``; ``state()``, ``memory_snapshot``,
``set_dtype`` (and ``float``/``double``/``half``/``type`` as no-ops), the
operator overloads and :class:`CompositionalMetric`. ``to``, ``set_dtype``,
``state_dict`` and ``load_state_dict`` recurse into child metrics held as
attributes (``_children``).

The engines (``metrics_tpu/metric.py:107-140, 449-474, 575, 595-668,
719-925``): ``jit_update=True`` sends every update through the fast-dispatch
engine (:mod:`metrics_tpu_torch.dispatch`: on the card one CUDA graph a
static key, pow2 shape bucket and dtype, with padded rows masked out) and
``forward`` through the fused forward (:mod:`metrics_tpu_torch.forward_engine`),
both behind the resilience policy (:mod:`metrics_tpu_torch.resilience`);
``scan_update`` folds a stack of batches as one program; ``dispatch_stats``
and ``forward_stats`` count what they did. As under ``jax.jit``, an engine's
program skips the input checks that read values back from the device
(:func:`~metrics_tpu_torch.utilities.checks.tracing`), and so does the eager
path that serves a ``jit_update`` call the engine declines.

Sync (``metrics_tpu/metric.py:224-390, 510-573, 612-686, 928, 1013-1433``):
``compute`` syncs the states across the processes of a ``torch.distributed``
group (:mod:`metrics_tpu_torch.parallel`), through the bucketed sync engine
(:mod:`metrics_tpu_torch.sync_engine`: one collective per wire dtype and
reduction, optionally on the int8 wire of :mod:`metrics_tpu_torch.quant`),
then the ragged list states, then the per-leaf rest, and restores the local
states afterwards; ``dist_sync_on_step``, ``process_group``, ``dist_sync_fn``,
``sync_env``, ``sync_dtype``, ``sync_precision``, ``add_state(quantize=,
shard_state=)``, ``sync``/``unsync``/``sync_context``, ``pure_sync``,
``assemble_sharded`` and ``sync_stats`` as in the JAX package, a process group
where it names a mesh axis. Sync never writes a state buffer: the synced
leaves are new tensors, and ``unsync`` restores the leaves an engine's graphs
go on from.

``compute_on_cpu=True`` (``metrics_tpu/metric.py:848-849, 1004-1009``)
moves every list state to the CPU after each update, so that ``compute``
runs there; the list states still sync through the metric's env.

Telemetry (``metrics_tpu/metric.py:819-847, 981-1000, 1043, 1370, 1426,
1447``, :mod:`metrics_tpu_torch.telemetry`): an update served outside the
engine emits an ``update`` span (kind ``eager``, or ``jit`` for a
``jit_update`` call the engine declined, where the JAX package runs
``jax.jit``), the engines their own spans, a non-memoised ``compute`` a
``compute`` span inside a ``torch.profiler`` range, a sync a ``sync`` span,
each collective of the per-leaf sync a ``collective`` event, and ``reset``
a ``reset`` instant. :meth:`Metric.telemetry_snapshot` merges the
per-owner stats.

A metric's states live on its device, ``cuda`` unless the caller passes
``device="cpu"``. Tensors given to ``update`` must lie on that device.
"""
import functools
import inspect
import operator
from abc import ABC, abstractmethod
from contextlib import contextmanager
from copy import deepcopy
from enum import Enum
from typing import Any, Callable, Dict, Generator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor

from metrics_tpu_torch import forward_engine, resilience, sync_engine, telemetry
from metrics_tpu_torch.dispatch import FastDispatcher, copy_tensors, engine_owned, fast_dispatch_enabled
from metrics_tpu_torch.parallel.dist_env import DistEnv, ProcessEnv, default_env, group_env
from metrics_tpu_torch.utilities.checks import tracing
from metrics_tpu_torch.utilities.checksums import attach_checksums, verify_checksums
from metrics_tpu_torch.utilities.data import (
    _flatten,
    _squeeze_if_scalar,
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
    dtype_name,
)
from metrics_tpu_torch.utilities.exceptions import MetricsUserError, StateCorruptionError  # noqa: F401 -- re-exported
from metrics_tpu_torch.utilities.prints import rank_zero_warn

StateType = Union[Tensor, List[Tensor]]

_REDUCTIONS = {
    "sum": dim_zero_sum,
    "mean": dim_zero_mean,
    "max": dim_zero_max,
    "min": dim_zero_min,
    "cat": dim_zero_cat,
}

def aot_cache_stats() -> Dict[str, Any]:
    """The ``aot_cache`` block of a telemetry snapshot, under the JAX package's
    keys. The port has no persistent program tier (ROADMAP.md, Queue A item
    13), so its counters stay 0 and it is never enabled."""
    return {"hits": 0, "misses": 0, "stores": 0, "corrupt": 0, "store_errors": 0, "enabled": False, "dir": None}


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The metric's device: ``cuda`` (the current card) unless given."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _raise_if_list_state(defaults: Dict[str, Any], owner: str) -> None:
    """``scan_update`` needs fixed-shape states (``metrics_tpu/metric.py:107``)."""
    for name, default in defaults.items():
        if isinstance(default, list):
            raise MetricsUserError(
                f"`scan_update` requires fixed-shape states, but state `{name}` of"
                f" {owner} is a list state. Use the per-batch `pure_update` loop"
                " (or a Binned* variant) instead."
            )


def _is_static_scalar(v: Any, numeric: bool = False) -> bool:
    """A flag-like argument that becomes part of an engine program's key
    instead of an input: bool, str, None and numpy bools always; int and
    float only with ``numeric``, so that a numeric kwarg that changes from
    batch to batch builds no new program (``metrics_tpu/metric.py:118``)."""
    if isinstance(v, (bool, str, np.bool_)) or v is None:
        return True
    return numeric and isinstance(v, (int, float))


def _split_static_kwargs(kwargs: Dict, numeric_static: bool) -> Tuple[Dict, Dict]:
    """``(static, dynamic)`` kwargs by :func:`_is_static_scalar`; numpy bools
    become Python bools, so that keys hash alike."""
    static = {
        k: (bool(v) if isinstance(v, np.bool_) else v)
        for k, v in kwargs.items()
        if _is_static_scalar(v, numeric_static)
    }
    return static, {k: v for k, v in kwargs.items() if k not in static}


def _scan_fold(update_fn: Callable, state: Any, batched_args: Tuple, batched_kwargs: Dict) -> Any:
    """``update_fn`` folded over the leading axis of the batched args and
    kwargs, as ``lax.scan`` folds it (``metrics_tpu/metric.py:143``); a
    Python scalar kwarg is a static flag of every step. Run it under
    :func:`~metrics_tpu_torch.utilities.checks.tracing`, as ``lax.scan``
    traces its body."""
    static_kwargs, batched_kwargs = _split_static_kwargs(batched_kwargs, numeric_static=True)
    leaves = [x for x in (*batched_args, *batched_kwargs.values()) if isinstance(x, Tensor)]
    if not leaves:
        raise MetricsUserError(
            "scan_update needs at least one batched argument (leading axis = "
            "num_batches); got none, so the scan length cannot be inferred"
        )
    lengths = {x.shape[0] if x.ndim else None for x in leaves}
    if len(lengths) != 1 or None in lengths:
        raise ValueError(f"scan_update got batched arguments of leading lengths {sorted(map(str, lengths))}")
    for i in range(lengths.pop()):
        args = tuple(x[i] if isinstance(x, Tensor) else x for x in batched_args)
        kwargs = {k: x[i] if isinstance(x, Tensor) else x for k, x in batched_kwargs.items()}
        state = update_fn(state, *args, **kwargs, **static_kwargs)
    return state


def _stable_default(x: Any, device: torch.device) -> Tensor:
    """A Python number becomes a 32-bit tensor (the JAX package's x64-off
    dtypes); a tensor keeps its dtype."""
    if isinstance(x, Tensor):
        return x.detach().clone().to(device)
    if isinstance(x, bool):
        return torch.tensor(x, device=device)
    if isinstance(x, int):
        return torch.tensor(x, dtype=torch.int32, device=device)
    return torch.tensor(x, dtype=torch.float32, device=device)


def _as_state(value: Any, device: torch.device) -> Tensor:
    """A checkpoint leaf (tensor or numpy array) as a fresh tensor on ``device``."""
    if isinstance(value, Tensor):
        return value.detach().to(device, copy=True)
    return torch.from_numpy(np.array(value)).to(device)


class Metric(ABC):
    """Base class for all metrics.

    Subclasses declare state in ``__init__`` via :meth:`add_state` and
    implement :meth:`update` and :meth:`compute`.

    Args:
        device: where the states live and the updates run; ``cuda`` by default.
        compute_on_cpu: move the list states to the CPU after each update
            (and so run ``compute`` there).
        dist_sync_on_step: sync the states inside every ``forward`` too.
        process_group: the ``torch.distributed`` process group a sync runs
            over (the default group where None).
        dist_sync_fn: a custom gather ``(tensor, env) -> List[Tensor]``.
        sync_env: an explicit :class:`~metrics_tpu_torch.parallel.DistEnv`;
            by default a ``ProcessEnv`` where ``torch.distributed`` is
            initialised with more than one rank, else none.
        jit_update: run updates through the fast-dispatch engine.
        sync_dtype: a float dtype (e.g. ``torch.bfloat16``) in which wider
            float states cross the wire, reduced at full precision after the
            cast back; integer and bool states always cross exact.
        sync_precision: ``"int8"``: the quantised wire for eligible states
            (:mod:`metrics_tpu_torch.quant`).
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = True
    # non-tensor attributes that belong in checkpoints (e.g. an inferred input mode)
    _aux_attributes: tuple = ()
    # tensor attributes that are not states but live on the metric's device (e.g. thresholds)
    _device_attributes: tuple = ()
    # count states kept in int64 where the JAX package's are int32 (x64 off); the checkpoint boundary
    # (metrics_tpu_torch.interop) widens them on loading and narrows them, range checked, on export
    _int64_states: tuple = ()

    def __init__(
        self,
        device: Optional[Union[str, torch.device]] = None,
        compute_on_cpu: bool = False,
        dist_sync_on_step: bool = False,
        process_group: Optional["dist.ProcessGroup"] = None,
        dist_sync_fn: Optional[Callable] = None,
        sync_env: Optional[DistEnv] = None,
        jit_update: bool = False,
        sync_dtype: Optional[torch.dtype] = None,
        sync_precision: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        if not isinstance(compute_on_cpu, bool):
            raise ValueError(f"Expected keyword argument `compute_on_cpu` to be a bool but got {compute_on_cpu}")
        self.compute_on_cpu = compute_on_cpu
        if not isinstance(dist_sync_on_step, bool):
            raise ValueError(f"Expected keyword argument `dist_sync_on_step` to be a bool but got {dist_sync_on_step}")
        self.dist_sync_on_step = dist_sync_on_step
        if process_group is not None and not isinstance(process_group, dist.ProcessGroup):
            raise ValueError(
                f"Expected keyword argument `process_group` to be a torch.distributed process group but got {process_group}"
            )
        self.process_group = process_group
        if dist_sync_fn is not None and not callable(dist_sync_fn):
            raise ValueError(f"Expected keyword argument `dist_sync_fn` to be a callable but got {dist_sync_fn}")
        self.dist_sync_fn = dist_sync_fn
        if isinstance(sync_dtype, str):  # a dtype's name, as jnp.dtype takes it
            sync_dtype = getattr(torch, sync_dtype, sync_dtype)
        if sync_dtype is not None and not (isinstance(sync_dtype, torch.dtype) and sync_dtype.is_floating_point):
            raise ValueError(f"Expected keyword argument `sync_dtype` to be a float dtype but got {sync_dtype}")
        self.sync_dtype = sync_dtype
        if sync_precision is not None and sync_precision != "int8":
            raise ValueError(
                f'Expected keyword argument `sync_precision` to be None or "int8" but got {sync_precision}'
            )
        self.sync_precision = sync_precision
        self._sync_env = sync_env
        self._device = resolve_device(device)
        self._jit_update_requested = bool(jit_update)
        # the fast-dispatch engine, built at the first engine call; its failures go through
        # the resilience policies (eager serves the call, the engine is benched for a cooldown)
        self._dispatcher: Optional[FastDispatcher] = None
        self._dispatch_resilience = resilience.ResiliencePolicy()
        self._dispatch_stats: Dict[str, int] = {"dispatches": 0, "retraces": 0}
        self._forward_resilience = resilience.ResiliencePolicy()
        self._forward_stats: Dict[str, Any] = {"launches": 0, "retraces": 0, "engine_us": 0.0}
        # the sync path's counters: collectives issued, buckets among them, payload bytes
        self._sync_stats: Dict[str, int] = {"collectives": 0, "buckets": 0, "bytes_on_wire": 0}

        self._update_signature = inspect.signature(self.update)
        self._update_impl: Callable = self.update
        self._compute_impl: Callable = self.compute
        self.update = self._wrap_update(self._update_impl)  # type: ignore[method-assign]
        self.compute = self._wrap_compute(self._compute_impl)  # type: ignore[method-assign]
        self._computed: Any = None
        self._forward_cache: Any = None
        self._update_count = 0
        # bumped on every edge that can change what compute() returns
        self._version = 0
        # compute's sync: whether it syncs, and whether it restores the local states afterwards
        self._to_sync = True
        self._should_unsync = True

        self._defaults: Dict[str, StateType] = {}
        self._persistent: Dict[str, bool] = {}
        self._reductions: Dict[str, Optional[Callable]] = {}
        # per leaf: whether it may cross the quantised wire, and the group its leading dim shards over
        self._quantize: Dict[str, bool] = {}
        self._shard_state: Dict[str, Any] = {}

        self._is_synced = False
        self._cache: Optional[Dict[str, StateType]] = None

    # ------------------------------------------------------------------ state
    def add_state(
        self,
        name: str,
        default: Union[Tensor, List, float, int],
        dist_reduce_fx: Optional[Union[str, Callable]] = None,
        persistent: bool = False,
        quantize: bool = True,
        shard_state: Any = None,
    ) -> None:
        """Declare a metric state: a tensor (or Python number) or an empty list.

        The reduction governs the sync across processes and ``forward``'s
        merge of a batch state into the global one: ``"sum"``, ``"mean"``,
        ``"max"``, ``"min"``, ``"cat"``, a callable on the stacked states, or
        None. ``quantize=False`` keeps the leaf off the quantised wire.

        ``shard_state`` declares the leaf's leading dim sharded over a
        process group (a ``torch.distributed`` group, or ``"world"`` for the
        default one): ``pure_sync(state, group)`` over that group leaves each
        rank its own ``d0/N`` rows (one reduce-scatter), and
        :meth:`assemble_sharded` / :meth:`pure_compute_sharded` gather them
        when needed. Every other sync, and ``METRICS_TPU_SHARD_STATE=0``,
        keeps the leaf whole.
        """
        if not isinstance(default, (list, int, float, Tensor)) or (isinstance(default, list) and default):
            raise ValueError("state variable must be an array or an empty list (where you can append arrays)")
        if shard_state is not None:
            if not (shard_state == "world" or isinstance(shard_state, dist.ProcessGroup)):
                raise ValueError(
                    f"`shard_state` must be a torch.distributed process group, \"world\" or None, got {shard_state!r}"
                )
            if isinstance(default, list):
                raise ValueError(f"state {name!r}: list states cannot be sharded (no fixed leading dim)")
            if not isinstance(default, Tensor) or default.ndim < 1:
                raise ValueError(f"state {name!r}: shard_state needs a leading dimension to shard, got a scalar default")
        if isinstance(dist_reduce_fx, str):
            if dist_reduce_fx not in _REDUCTIONS:
                raise ValueError(
                    "`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', 'min', 'max', None]"
                )
            dist_reduce_fx = _REDUCTIONS[dist_reduce_fx]
        elif dist_reduce_fx is not None and not callable(dist_reduce_fx):
            raise ValueError("`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', 'min', 'max', None]")

        default = [] if isinstance(default, list) else _stable_default(default, self._device)
        object.__setattr__(self, name, [] if isinstance(default, list) else default.clone())
        self._defaults[name] = default
        self._persistent[name] = persistent
        self._reductions[name] = dist_reduce_fx
        self._quantize[name] = bool(quantize)
        if shard_state is not None:
            self._shard_state[name] = shard_state
        else:
            self._shard_state.pop(name, None)

    def _copy_state(self) -> Dict[str, StateType]:
        return {k: list(v) if isinstance(v, list) else v for k, v in ((k, getattr(self, k)) for k in self._defaults)}

    def state(self) -> Dict[str, StateType]:
        """The current state as a dict: tensors are copies and lists are
        shallow copies, so nothing done to the result reaches the metric."""
        return {k: list(v) if isinstance(v, list) else v.clone() for k, v in self._copy_state().items()}

    def _load_state(self, state: Dict[str, StateType]) -> None:
        for k, v in state.items():
            object.__setattr__(self, k, list(v) if isinstance(v, (list, tuple)) else v)

    @property
    def state_version(self) -> int:
        """Monotonic counter of state mutations: two reads of an equal
        version see identical state."""
        return self._version

    def _bump_version(self) -> None:
        self._version += 1

    # ------------------------------------------------------------- pure API
    def default_state(self) -> Dict[str, StateType]:
        """A fresh default state (the state ``reset()`` installs)."""
        return {k: [] if isinstance(v, list) else v.clone() for k, v in self._defaults.items()}

    def pure_update(self, state: Dict[str, StateType], *args: Any, **kwargs: Any) -> Dict[str, StateType]:
        """``(state, batch) -> state``; the metric's own state is left as it was."""
        saved = self._copy_state()
        try:
            self._load_state(state)
            self._update_impl(*args, **kwargs)
            return self._copy_state()
        finally:
            self._load_state(saved)

    def _masked_update_supported(self) -> bool:
        """Whether :meth:`_masked_update` makes padded rows exact no-ops in
        the metric's configuration; a metric that supports shape-bucketed
        dispatch overrides both. The default opts out."""
        return False

    def _masked_update(self, sample_mask: Tensor, *args: Any, **kwargs: Any) -> None:
        """``update`` with a dim-0 validity mask: rows where the mask is False
        add nothing to the state."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement masked updates; "
            "the fast-dispatch engine will use exact-shape programs."
        )

    def _masked_pure_update(
        self, state: Dict[str, StateType], sample_mask: Tensor, *args: Any, **kwargs: Any
    ) -> Dict[str, StateType]:
        """:meth:`_masked_update` as ``(state, batch) -> state``, as :meth:`pure_update`."""
        saved = self._copy_state()
        try:
            self._load_state(state)
            self._masked_update(sample_mask, *args, **kwargs)
            return self._copy_state()
        finally:
            self._load_state(saved)

    def pure_compute(self, state: Dict[str, StateType]) -> Any:
        """The metric's value for a state."""
        saved = self._copy_state()
        try:
            self._load_state(state)
            return self._compute_impl()
        finally:
            self._load_state(saved)

    def pure_merge(self, state_a: Dict[str, StateType], state_b: Dict[str, StateType], count: Any = 2) -> Dict[str, StateType]:
        """Merge two partial states with the declared reductions. ``count`` is
        the number of updates the merged state stands for (mean states only)."""
        saved = self._copy_state()
        saved_count = self._update_count
        try:
            self._load_state(state_b)
            self._update_count = count
            self._reduce_states(state_a)
            return self._copy_state()
        finally:
            self._update_count = saved_count
            self._load_state(saved)

    def pure_sync(
        self, state: Dict[str, StateType], group: Optional["dist.ProcessGroup"] = None, env: Optional[DistEnv] = None
    ) -> Dict[str, StateType]:
        """``state`` synced over the ranks of ``group`` (the default group
        where None), the metric's own state left as it was: the JAX package's
        ``pure_sync(state, axis_name)``. Leaves declared ``shard_state=`` over
        that group come back sharded (each rank its own rows). ``env`` gives
        the collectives explicitly instead (a loopback env in tests)."""
        env = env or group_env(group)
        saved = self._copy_state()
        try:
            self._load_state(state)
            self._sync_dist(dist_sync_fn=None, env=env)
            return self._copy_state()
        finally:
            self._load_state(saved)

    def sharded_axes(self) -> Dict[str, Any]:
        """``{leaf: group}`` of the leaves declared ``shard_state=``; empty with
        ``METRICS_TPU_SHARD_STATE=0``, which keeps every leaf whole."""
        if not self._shard_state or not sync_engine.shard_state_enabled():
            return {}
        return dict(self._shard_state)

    def assemble_sharded(
        self, state: Dict[str, StateType], group: Optional["dist.ProcessGroup"] = None, env: Optional[DistEnv] = None
    ) -> Dict[str, StateType]:
        """The sharded leaves of a synced ``state`` gathered back to their
        full shape over ``group`` (one gather a leaf); whole leaves pass
        through, so the call is safe on either layout."""
        axes = self.sharded_axes()
        if not axes:
            return dict(state)
        env = env or group_env(group)
        out = dict(state)
        for attr, declared in axes.items():
            v = out.get(attr)
            if not sync_engine.shards_group(env, declared) or not isinstance(v, Tensor) or v.ndim < 1:
                continue
            if v.shape[0] < self._defaults[attr].shape[0]:
                out[attr] = torch.cat(env.all_gather_uniform(v))
        return out

    def pure_compute_sharded(
        self, state: Dict[str, StateType], group: Optional["dist.ProcessGroup"] = None, env: Optional[DistEnv] = None
    ) -> Any:
        """:meth:`pure_compute` of a sharded synced state, assembled first:
        every rank gets the full value."""
        return self.pure_compute(self.assemble_sharded(state, group, env))

    def scan_update(
        self, state: Dict[str, StateType], *batched_args: Any, **batched_kwargs: Any
    ) -> Dict[str, StateType]:
        """Fold a stack of batches into ``state`` as one program.

        The arguments carry a leading ``num_batches`` axis; each slice is one
        :meth:`pure_update`, run as ``lax.scan`` runs its body (the input checks
        that read values skipped). On the card the fold is one CUDA graph a
        (stack, batch) shape; the metric's own state is left as it was.
        Requires fixed-shape states.
        """
        _raise_if_list_state(self._defaults, f"{self.__class__.__name__}")
        batched_args, batched_kwargs = self._normalize_update_args(batched_args, batched_kwargs)
        if self._device.type == "cuda" and fast_dispatch_enabled():
            static, dynamic = _split_static_kwargs(batched_kwargs, numeric_static=True)
            if self._dispatcher is None:
                self._dispatcher = self._make_dispatcher()
            names = list(self._defaults)
            out = self._dispatcher.scan(static, tuple(sorted(static.items())), tuple(state[k] for k in names),
                                        batched_args, dynamic)
            return dict(zip(names, out))
        with tracing():
            return _scan_fold(self.pure_update, state, batched_args, batched_kwargs)

    # --------------------------------------------------------------- forward
    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate the batch and return the metric's value on it alone.

        With ``jit_update=True`` and tensor states the whole step is one
        program of the fused forward (:mod:`metrics_tpu_torch.forward_engine`);
        the eager branches serve it where the engine is off or declines.
        """
        if self._is_synced:
            raise MetricsUserError(
                "The Metric shouldn't be synced when performing ``forward``. "
                "HINT: Did you forget to call ``unsync``?"
            )
        if (
            self._jit_update_requested
            # a sync each step is a collective, which a graph does not hold
            and not self.dist_sync_on_step
            and not self._dispatch_resilience.permanent
            and forward_engine.fused_forward_enabled()
            and fast_dispatch_enabled()
            and not any(isinstance(v, list) for v in self._defaults.values())
            # last: allow() uses up a cooldown call
            and self._forward_resilience.allow()
        ):
            snap = resilience.snapshot_state(self) if resilience.resilience_enabled() else None
            try:
                batch_val = forward_engine.metric_forward(self, args, kwargs)
                if snap is not None and resilience.verify_after_call():
                    resilience.verify_engine_state(self, snap, where="forward")
                self._forward_resilience.note_success()
                self._forward_cache = batch_val
                return batch_val
            except Exception as err:  # noqa: BLE001 -- degrade to the eager branches, never escape
                if snap is not None:
                    resilience.restore_state(self, snap)
                resilience.record_degrade(type(self).__name__, "forward", err, self._forward_resilience)
        if self.full_state_update or self.full_state_update is None or self.dist_sync_on_step:
            self._forward_cache = self._forward_full_state_update(*args, **kwargs)
        else:
            self._forward_cache = self._forward_reduce_state_update(*args, **kwargs)
        return self._forward_cache

    def _held_state(self) -> Dict[str, StateType]:
        """:meth:`_copy_state` to hold across an update: a leaf an engine
        writes in place is copied, every other leaf held as it is."""
        return {k: v.clone() if engine_owned(v) else v for k, v in self._copy_state().items()}

    def _engine_free(self, value: Any) -> Any:
        """``value`` with each tensor that shares memory with a state leaf an
        engine writes in place (this metric's or its collection's) copied, so
        that later replays leave it as it is."""
        owned = {
            v.untyped_storage().data_ptr() for v in (getattr(self, k) for k in self._defaults) if engine_owned(v)
        }
        if not owned:
            return value
        return copy_tensors(value, lambda t: t.untyped_storage().data_ptr() in owned)

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """Two updates: one on the global state, one on a fresh state for the
        batch value (synced across processes only with ``dist_sync_on_step``)."""
        self.update(*args, **kwargs)
        self._to_sync = self.dist_sync_on_step
        cache = self._held_state()
        kept = self._held_tree()
        update_count = self._update_count
        self.reset()
        self.update(*args, **kwargs)
        self._should_unsync = False
        batch_val = self.compute()

        self._update_count = update_count
        self._load_state(cache)
        self._restore_tree(kept)
        # the batch value's sync is dropped with its state. The JAX package leaves _is_synced set here
        # (metrics_tpu/metric.py:649-667), so its next forward raises; TorchMetrics clears it, as here
        self._is_synced = False
        self._cache = None
        self._should_unsync = True
        self._to_sync = True
        self._computed = None
        self._bump_version()
        return batch_val

    def _held_tree(self) -> List[Tuple["Metric", Dict[str, StateType], int, Dict[str, Any]]]:
        """What forward's ``reset`` would lose beside the own states: the
        ``_device_attributes`` of this metric, and the states, update counts
        and device attributes of every metric below it (``_children``). A
        wrapper's accumulated value lives in its children; the JAX package's
        forward resets them and keeps the batch alone (ROADMAP.md, Queue C)."""
        held = [(self, {}, self._update_count, {n: getattr(self, n) for n in self._device_attributes})]
        stack = [child for _, child in self._children()]
        while stack:
            m = stack.pop()
            held.append((m, m._held_state(), m._update_count, {n: getattr(m, n) for n in m._device_attributes}))
            stack.extend(child for _, child in m._children())
        return held

    def _restore_tree(self, held: List[Tuple["Metric", Dict[str, StateType], int, Dict[str, Any]]]) -> None:
        for m, state, count, attrs in held:
            m._load_state(state)
            for name, value in attrs.items():
                object.__setattr__(m, name, value)
            if m is not self:
                m._update_count = count
                m._computed = None
                m._bump_version()

    def _forward_reduce_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """One update on a fresh state, merged into the global one by the reductions."""
        global_state = self._held_state()
        update_count = self._update_count
        self.reset()
        self._to_sync = self.dist_sync_on_step
        self._should_unsync = False
        self.update(*args, **kwargs)
        batch_val = self.compute()

        self._update_count = update_count + 1
        self._reduce_states(global_state)
        self._should_unsync = True
        self._to_sync = True
        self._computed = None
        self._bump_version()
        return batch_val

    def _reduce_states(self, incoming_state: Dict[str, StateType]) -> None:
        """Merge ``incoming_state`` (global) into the current (batch) state."""
        for attr in self._defaults:
            local_state = getattr(self, attr)
            global_state = incoming_state[attr]
            reduce_fn = self._reductions[attr]
            if reduce_fn is dim_zero_sum:
                reduced = global_state + local_state
            elif reduce_fn is dim_zero_mean:
                reduced = ((self._update_count - 1) * global_state + local_state) / self._update_count
            elif reduce_fn is dim_zero_max:
                reduced = torch.maximum(global_state, local_state)
            elif reduce_fn is dim_zero_min:
                reduced = torch.minimum(global_state, local_state)
            elif reduce_fn is dim_zero_cat:
                if isinstance(global_state, list):
                    reduced = list(global_state) + list(local_state)
                else:
                    reduced = torch.cat([torch.atleast_1d(global_state), torch.atleast_1d(local_state)])
            elif reduce_fn is None and isinstance(global_state, list):
                reduced = _flatten([global_state, local_state])
            elif reduce_fn is None:
                reduced = torch.stack([global_state, local_state])
            else:
                reduced = reduce_fn(torch.stack([global_state, local_state]))
            object.__setattr__(self, attr, reduced)

    # -------------------------------------------------------------- wrappers
    def _check_devices(self, args: tuple, kwargs: Dict[str, Any]) -> None:
        for value in (*args, *kwargs.values()):
            if isinstance(value, Tensor) and value.device != self._device:
                raise RuntimeError(
                    f"Expected all tensors to be on the metric's device {self._device}, "
                    f"but found one on {value.device}"
                )

    def _normalize_update_args(self, args: Tuple, kwargs: Dict) -> Tuple[Tuple, Dict]:
        """Bind ``update(*args, **kwargs)`` to the update's signature, named
        positionals moved into kwargs (so that a flag is found however it was
        passed); the pair as it was where binding fails."""
        try:
            bound = self._update_signature.bind(*args, **kwargs)
        except TypeError:
            return args, kwargs
        out_args: list = []
        out_kwargs: Dict[str, Any] = {}
        for name, val in bound.arguments.items():
            param = self._update_signature.parameters[name]
            if param.kind is param.VAR_POSITIONAL:
                out_args.extend(val)
            elif param.kind is param.VAR_KEYWORD:
                out_kwargs.update(val)
            elif param.kind is param.POSITIONAL_ONLY:
                out_args.append(val)
            else:
                out_kwargs[name] = val
        return tuple(out_args), out_kwargs

    def _split_update_args(self, args: Tuple, kwargs: Dict) -> Tuple[Tuple, Dict, Dict, Tuple]:
        """``(args, static, dynamic, key)`` of an engine call: flag arguments
        select Python control flow in ``update``, so they join the program's
        key instead of its inputs; numbers stay inputs."""
        if any(_is_static_scalar(v) for v in args) or any(_is_static_scalar(v) for v in kwargs.values()):
            args, kwargs = self._normalize_update_args(args, kwargs)
            static, dynamic = _split_static_kwargs(kwargs, numeric_static=False)
            return args, static, dynamic, tuple(sorted(static.items()))
        return args, {}, kwargs, ()

    def _wrap_update(self, update: Callable) -> Callable:
        @functools.wraps(update)
        def wrapped_func(*args: Any, **kwargs: Any) -> None:
            self._check_devices(args, kwargs)
            self._computed = None
            self._update_count += 1
            self._bump_version()
            t0 = telemetry.clock()
            if not self._jit_update_requested or any(isinstance(v, list) for v in self._defaults.values()):
                update(*args, **kwargs)
                kind, attrs = "eager", {}
            elif self._engine_update(args, kwargs):
                return  # the engine counted its dispatch and emitted its span
            else:
                # the eager path, as the JAX package's jax.jit fallback: the checks that read values skipped
                t0 = telemetry.clock()
                with tracing():
                    update(*args, **kwargs)
                kind, attrs = "jit", {"static_key": self._split_update_args(args, kwargs)[3] or None}
            self._dispatch_stats["dispatches"] += 1
            telemetry.emit("update", type(self).__name__, kind, t0=t0, stream="dispatch", **attrs)
            if self.compute_on_cpu:
                self._move_list_states_to_cpu()

        return wrapped_func

    def _move_list_states_to_cpu(self) -> None:
        """Move every list state's elements to the CPU."""
        for key in self._defaults:
            current = getattr(self, key)
            if isinstance(current, list):
                object.__setattr__(self, key, [v.cpu() for v in current])

    def _engine_update(self, args: Tuple, kwargs: Dict) -> bool:
        """One update through the fast-dispatch engine; False where it is off,
        cooling down or failed (the state then as before the call)."""
        if not fast_dispatch_enabled() or not self._dispatch_resilience.allow():
            return False
        call_args, static, dynamic, key = self._split_update_args(args, kwargs)
        # the counters already moved, and the eager path serves a failed call: leaves only
        snap = resilience.snapshot_state(self, counters=False) if resilience.resilience_enabled() else None
        try:
            if self._dispatcher is None:
                self._dispatcher = self._make_dispatcher()
            self._dispatcher.update(static, key, call_args, dynamic)
            if snap is not None and resilience.verify_after_call():
                resilience.verify_engine_state(self, snap, where="update")
            self._dispatch_resilience.note_success()
            return True
        except Exception as err:  # noqa: BLE001 -- degrade to the eager path (cooldown; permanent if unsupported)
            if snap is not None:
                resilience.restore_state(self, snap)
            resilience.record_degrade(type(self).__name__, "dispatch", err, self._dispatch_resilience)
            if self._dispatch_resilience.permanent:
                self._dispatcher = None
            return False

    def _make_dispatcher(self) -> FastDispatcher:
        """This metric's fast-dispatch engine (``metrics_tpu/metric.py:854``)."""
        names = list(self._defaults)

        def read_leaves() -> Tuple:
            return tuple(getattr(self, k) for k in names)

        def write_leaves(leaves: Tuple) -> None:
            for k, v in zip(names, leaves):
                object.__setattr__(self, k, v)

        def make_update(static: Dict) -> Callable:
            def fn(leaves, *args, **dyn):
                new = self.pure_update(dict(zip(names, leaves)), *args, **dyn, **static)
                return tuple(new[k] for k in names)

            return fn

        def make_masked_update(static: Dict) -> Callable:
            def fn(n_valid, leaves, *args, **dyn):
                mask = forward_engine.padded_mask(args, dyn, n_valid)
                new = self._masked_pure_update(dict(zip(names, leaves)), mask, *args, **dyn, **static)
                return tuple(new[k] for k in names)

            return fn

        def make_scan(static: Dict) -> Callable:
            def fn(leaves, *args, **dyn):
                new = _scan_fold(self.pure_update, dict(zip(names, leaves)), args, {**dyn, **static})
                return tuple(new[k] for k in names)

            return fn

        make_forward, make_masked_forward = forward_engine.make_metric_forward_factories(self, names)
        return FastDispatcher(
            type(self).__name__,
            self._device,
            read_leaves,
            write_leaves,
            make_update,
            make_masked_update,
            masking_ok=self._masked_update_supported,
            stats=self._dispatch_stats,
            make_forward=make_forward,
            make_masked_forward=make_masked_forward,
            forward_stats=self._forward_stats,
            make_scan=make_scan,
        )

    @property
    def dispatch_stats(self) -> Dict[str, Any]:
        """Update counters: ``dispatches`` (updates), ``retraces`` (programs
        built), ``evictions`` once the cache evicts, and the resilience
        policy's ``demotions``, ``repromotions``, ``cooldown``, ``permanent``
        and ``last_cause``."""
        stats: Dict[str, Any] = dict(self._dispatch_stats)
        stats.update(self._dispatch_resilience.stats())
        return stats

    @property
    def forward_stats(self) -> Dict[str, Any]:
        """Fused-forward counters: ``launches``, ``retraces``, host
        ``engine_us``, and the forward policy's degradation state."""
        stats: Dict[str, Any] = dict(self._forward_stats)
        stats.update(self._forward_resilience.stats())
        return stats

    def _wrap_compute(self, compute: Callable) -> Callable:
        @functools.wraps(compute)
        def wrapped_func(*args: Any, **kwargs: Any) -> Any:
            if self._update_count == 0:
                rank_zero_warn(
                    f"The ``compute`` method of metric {self.__class__.__name__}"
                    " was called before the ``update`` method which may lead to errors,"
                    " as metric states have not yet been updated.",
                    UserWarning,
                )
            if self._computed is None:
                name = type(self).__name__
                with self.sync_context(
                    dist_sync_fn=self.dist_sync_fn, should_sync=self._to_sync, should_unsync=self._should_unsync
                ), telemetry.profiler_range(f"metrics_tpu.{name}.compute"), telemetry.span(
                    "compute", name, "metric"
                ):
                    self._computed = self._engine_free(_squeeze_if_scalar(compute(*args, **kwargs)))
            return self._computed

        return wrapped_func

    # ------------------------------------------------------------------ sync
    @property
    def sync_stats(self) -> Dict[str, int]:
        """The sync path's counters: ``collectives`` issued, ``buckets``
        among them, ``bytes_on_wire``, and once a bucket ran
        ``bytes_logical`` (the states' own bytes) and ``sharded_buckets``."""
        return dict(self._sync_stats)

    def _sync_dist(
        self,
        dist_sync_fn: Optional[Callable] = None,
        env: Optional[DistEnv] = None,
        exclude: Sequence[str] = (),
    ) -> None:
        """Gather every state across the participants and reduce it
        (``metrics_tpu/metric.py:1013-1264``). ``exclude`` names states a
        caller synced already (a collection's shared bucket pass).

        Every rank issues the same collectives in the same order: the
        emptiness probe of the list states, then the buckets, then the
        ragged states, then the per-leaf rest. Nothing is written into a
        state tensor: every synced leaf is a new tensor.
        """
        env = env or self._resolve_env()
        # a collective runs when the env is distributed or the user gave a gather of their own
        will_communicate = env.is_distributed() or dist_sync_fn is not None

        def _record(kind: str, x: Tensor, logical: Optional[int] = None) -> None:
            # each collective with its bytes on the wire, and the state's own where it crossed narrowed
            if will_communicate:
                nbytes = x.numel() * x.element_size()
                self._sync_stats["collectives"] += 1
                self._sync_stats["bytes_on_wire"] += nbytes
                telemetry.emit("collective", type(self).__name__, kind, nbytes=nbytes,
                               logical_nbytes=nbytes if logical is None else int(logical), dtype=dtype_name(x.dtype))

        if dist_sync_fn is not None:
            def base_gather(x: Tensor, logical: Optional[int] = None) -> List[Tensor]:
                _record("gather", x, logical)
                return dist_sync_fn(x, env)

            uniform_gather = base_gather  # a custom gather sees every state as it is
        else:
            def base_gather(x: Tensor, logical: Optional[int] = None) -> List[Tensor]:
                _record("gather", x, logical)
                return env.all_gather(x)

            def uniform_gather(x: Tensor, logical: Optional[int] = None) -> List[Tensor]:
                # fixed-shape states have one shape on every rank: no size exchange
                _record("gather", x, logical)
                return env.all_gather_uniform(x)

        def _would_compress(x: Tensor) -> bool:
            return (
                self.sync_dtype is not None
                and will_communicate
                and x.is_floating_point()
                and x.dtype.itemsize > self.sync_dtype.itemsize
            )

        def _compressed(inner: Callable) -> Callable:
            # float states cross in sync_dtype and come back in their own dtype, reduced at full precision
            def gather(x: Tensor) -> List[Tensor]:
                if _would_compress(x):
                    return [g.to(x.dtype) for g in inner(x.to(self.sync_dtype), x.numel() * x.element_size())]
                return inner(x)

            return gather

        input_dict = {attr: getattr(self, attr) for attr in self._reductions if attr not in exclude}
        # ragged list states re-split by their gathered lengths; a deterministic order on every rank
        ragged_specs = getattr(self, "_ragged_state_specs", None) or {}
        ragged_attrs = [a for a in ragged_specs if isinstance(input_dict.get(a), list)]

        # the list states' emptiness, probed in one int32 collective before anything is written: all
        # empty is a no-op, mixed emptiness raises on every rank (an empty rank has nothing to contribute,
        # and the collectives would fall out of step), all non-empty goes on
        if will_communicate:
            probe_attrs = [a for a, v in input_dict.items() if isinstance(v, list) and a not in ragged_attrs]
            if probe_attrs:
                counts_vec = uniform_gather(
                    torch.tensor([len(input_dict[a]) for a in probe_attrs], dtype=torch.int32, device=self._device)
                )
                per_rank = [c.cpu().tolist() for c in counts_vec]
                for i, attr in enumerate(probe_attrs):
                    counts = [int(r[i]) for r in per_rank]
                    if max(counts) == 0:
                        object.__setattr__(self, attr, [])
                        del input_dict[attr]
                    elif min(counts) == 0:
                        raise MetricsUserError(
                            f"Cross-process sync of list state `{attr}`: some ranks"
                            f" never updated it (per-rank element counts {counts})."
                            " A generic list state needs at least one element on"
                            " every rank: either ensure every rank updates, or"
                            " declare `_ragged_state_specs` for it (a"
                            " (trailing_shape, dtype) spec lets empty ranks join"
                            " the collectives, see retrieval/base.py)."
                        )

        # the buckets: every fixed-shape leaf of a named reduction, one collective a (wire dtype, op); a custom
        # gather sees every state, so it is never bucketed
        if dist_sync_fn is None and will_communicate and sync_engine.fused_sync_enabled():
            try:
                specs = sync_engine.plan_metric_leaves(self, input_dict)
                if specs:
                    fused = sync_engine.execute_buckets(env, specs, owner=type(self).__name__, stats=self._sync_stats)
                    for attr, val in fused.items():
                        object.__setattr__(self, attr, val)
                        del input_dict[attr]
            except Exception as err:  # noqa: BLE001 -- the per-leaf protocol below serves every leaf
                if not resilience.resilience_enabled():
                    raise
                resilience.record_degrade(type(self).__name__, "sync", err)
                rank_zero_warn(
                    f"fused sync engine failed for {type(self).__name__} "
                    f"({type(err).__name__}: {err}); syncing per-leaf instead"
                )

        lengths_cache: Dict[str, Any] = {}
        for attr in ragged_attrs:
            object.__setattr__(self, attr, self._gather_ragged(attr, input_dict.pop(attr), base_gather, lengths_cache))

        for attr in input_dict:
            # a list state crosses as one concatenated tensor
            if isinstance(input_dict[attr], list) and len(input_dict[attr]) >= 1:
                input_dict[attr] = [dim_zero_cat(input_dict[attr])]

        output_dict: Dict[str, Any] = {}
        for attr, value in input_dict.items():
            # a named reduction is one native collective, where the env has one and nothing narrows the leaf
            if dist_sync_fn is None and not isinstance(value, list) and not _would_compress(value):
                op = sync_engine.NATIVE_REDUCE_OPS.get(self._reductions[attr])
                if op is not None:
                    reduced = env.all_reduce(value, op)
                    if reduced is not None:
                        _record("reduce", value)
                        object.__setattr__(self, attr, reduced)
                        continue
            # raw samples (list and cat states, _sample_state_names) are never narrowed: they would stay so
            samples = (
                isinstance(value, list)
                or self._reductions[attr] is dim_zero_cat
                or attr in getattr(self, "_sample_state_names", ())
            )
            if isinstance(value, list):
                output_dict[attr] = [base_gather(v) for v in value]
            else:
                # only cat-reduced tensors may have rank-dependent leading dims
                inner = base_gather if self._reductions[attr] is dim_zero_cat else uniform_gather
                output_dict[attr] = inner(value) if samples else _compressed(inner)(value)

        for attr, out in output_dict.items():
            reduction_fn = self._reductions[attr]
            if isinstance(out, list) and len(out) == 0:
                object.__setattr__(self, attr, [])
                continue
            if isinstance(out[0], list):  # a list state: the ranks' lists flattened
                out = _flatten(out)
            elif isinstance(out[0], Tensor):
                out = torch.stack(out)
            object.__setattr__(self, attr, reduction_fn(out) if reduction_fn is not None else out)

    def _gather_ragged(
        self, attr: str, value: list, base_gather: Callable, lengths_cache: Dict[str, Any]
    ) -> list:
        """Gather a list state whose elements' boundaries matter
        (``metrics_tpu/metric.py:1266``): declared
        ``_ragged_state_specs[attr] = (trailing_shape, dtype[, lengths_group])``.

        The elements' lengths and their concatenation cross in two gathers,
        and every rank's data is split again by its lengths, so ranks with
        different (even zero) element counts stay in step: the declared
        trailing shape and dtype make an empty rank's placeholder. States of
        one ``lengths_group`` share one lengths gather.
        """
        spec = self._ragged_state_specs[attr]
        trailing, dtype, group = spec if len(spec) == 3 else (*spec, None)
        local_lengths = tuple(int(v.shape[0]) for v in value)
        if group is not None and group in lengths_cache:
            cached_local, gathered_lengths = lengths_cache[group]
            if cached_local != local_lengths:
                raise MetricsUserError(
                    f"Ragged states in lengths_group {group!r} disagree on element"
                    f" lengths ({attr}: {local_lengths} vs {cached_local}); states in"
                    " one group must always be updated together."
                )
        else:
            lengths = torch.tensor(local_lengths, dtype=torch.int32, device=self._device)
            gathered_lengths = [g.cpu().tolist() for g in base_gather(lengths)]
            if group is not None:
                lengths_cache[group] = (local_lengths, gathered_lengths)
        data = dim_zero_cat(value).to(dtype) if value else torch.zeros((0, *trailing), dtype=dtype, device=self._device)
        out: list = []
        for rank_lengths, rank_data in zip(gathered_lengths, base_gather(data)):
            if rank_lengths:
                out.extend(torch.split(rank_data, list(rank_lengths)))
        return out

    def _resolve_env(self) -> DistEnv:
        if self._sync_env is not None:
            return self._sync_env
        if self.process_group is not None:
            return ProcessEnv(self.process_group)
        return default_env()

    def sync(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional["dist.ProcessGroup"] = None,
        should_sync: bool = True,
        distributed_available: Optional[Callable] = None,
        env: Optional[DistEnv] = None,
    ) -> None:
        """Sync the states across the environment: ``env``, else a
        ``ProcessEnv`` over ``process_group`` where given, else the metric's
        own (``sync_env``, ``process_group``, or the ambient default). The
        local states are kept for :meth:`unsync`."""
        if self._is_synced and should_sync:
            raise MetricsUserError("The Metric has already been synced.")
        if not should_sync:
            return
        if env is None:
            env = ProcessEnv(process_group) if process_group is not None else self._resolve_env()
        if not (env.is_distributed() if distributed_available is None else bool(distributed_available())):
            return
        if dist_sync_fn is None:
            dist_sync_fn = self.dist_sync_fn
        self._cache = self._copy_state()
        with telemetry.span("sync", type(self).__name__, "metric"):
            self._sync_dist(dist_sync_fn, env=env)
        self._is_synced = True
        self._bump_version()

    def unsync(self, should_unsync: bool = True) -> None:
        """Restore the local states :meth:`sync` kept (the very tensors, so an
        engine's graphs go on from their own buffers)."""
        if not should_unsync:
            return
        if not self._is_synced:
            raise MetricsUserError("The Metric has already been un-synced.")
        if self._cache is None:
            raise MetricsUserError("The internal cache should exist to unsync the Metric.")
        self._load_state(self._cache)
        self._is_synced = False
        self._cache = None
        self._bump_version()

    @contextmanager
    def sync_context(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional["dist.ProcessGroup"] = None,
        should_sync: bool = True,
        should_unsync: bool = True,
        distributed_available: Optional[Callable] = None,
        env: Optional[DistEnv] = None,
    ) -> Generator[None, None, None]:
        """sync, the block, unsync."""
        self.sync(
            dist_sync_fn=dist_sync_fn,
            process_group=process_group,
            should_sync=should_sync,
            distributed_available=distributed_available,
            env=env,
        )
        yield
        self.unsync(should_unsync=self._is_synced and should_unsync)

    @abstractmethod
    def update(self, *_: Any, **__: Any) -> None:
        """Accumulate statistics for this batch into the metric state."""

    @abstractmethod
    def compute(self) -> Any:
        """Compute the final value from the accumulated state."""

    def reset(self) -> None:
        """Restore all states to their defaults."""
        telemetry.emit("reset", type(self).__name__, "metric")
        self._update_count = 0
        self._forward_cache = None
        self._computed = None
        self._bump_version()
        for attr, default in self.default_state().items():
            object.__setattr__(self, attr, default)
        self._cache = None
        self._is_synced = False

    def clone(self) -> "Metric":
        return deepcopy(self)

    def __deepcopy__(self, memo: Dict[int, Any]) -> "Metric":
        # a process group (and an env over one) is a live communicator: a copy shares it. It cannot be pickled,
        # so a metric that holds one does not pickle either
        for held in (self.process_group, self._sync_env, *self._shard_state.values()):
            if held is not None and not isinstance(held, str):
                memo[id(held)] = held
        new = type(self).__new__(type(self))
        memo[id(self)] = new
        new.__setstate__(deepcopy(self.__getstate__(), memo))
        return new

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    # -------------------------------------------------------------- pickling
    def __getstate__(self) -> Dict[str, Any]:
        # the wrapped bound methods are rebuilt in __setstate__
        # and the engine's graphs and buffers are made again at the next engine call
        skip = ("update", "compute", "_update_impl", "_compute_impl", "_update_signature", "_dispatcher")
        return {k: v for k, v in self.__dict__.items() if k not in skip}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._dispatcher = None
        self._update_signature = inspect.signature(self.update)
        self._update_impl = type(self).update.__get__(self)
        self._compute_impl = type(self).compute.__get__(self)
        self.update = self._wrap_update(self._update_impl)  # type: ignore[method-assign]
        self.compute = self._wrap_compute(self._compute_impl)  # type: ignore[method-assign]

    def __setattr__(self, name: str, value: Any) -> None:
        if name in ("higher_is_better", "is_differentiable", "full_state_update"):
            raise RuntimeError(f"Can't change const `{name}`.")
        object.__setattr__(self, name, value)

    # ---------------------------------------------------------------- device
    @property
    def device(self) -> torch.device:
        return self._device

    def to(self, device: Union[str, torch.device]) -> "Metric":
        """Move every state (and its default), and the tensor attributes named
        in ``_device_attributes``, to ``device``."""
        self._device = resolve_device(device)
        self._dispatcher = None  # its programs and buffers are for the old device
        for name in self._device_attributes:
            object.__setattr__(self, name, getattr(self, name).to(self._device))
        for attr in self._defaults:
            value = getattr(self, attr)
            if isinstance(value, list):
                object.__setattr__(self, attr, [v.to(self._device) for v in value])
            else:
                object.__setattr__(self, attr, value.to(self._device))
            if not isinstance(self._defaults[attr], list):
                self._defaults[attr] = self._defaults[attr].to(self._device)
        self._computed = None
        for _, child in self._children():
            child.to(device)
        return self

    def float(self) -> "Metric":
        """No-op, as in the JAX package: only :meth:`set_dtype` changes a state's dtype."""
        return self

    def double(self) -> "Metric":
        """No-op; use :meth:`set_dtype`."""
        return self

    def half(self) -> "Metric":
        """No-op; use :meth:`set_dtype`."""
        return self

    def type(self, dst_type: Any = None) -> "Metric":
        """No-op; use :meth:`set_dtype`."""
        return self

    def set_dtype(self, dst_type: torch.dtype) -> "Metric":
        """Cast the floating-point states, and their defaults, to ``dst_type``."""

        def _cast(x: Any) -> Any:
            return x.to(dst_type) if isinstance(x, Tensor) and x.is_floating_point() else x

        for attr in self._defaults:
            value = getattr(self, attr)
            object.__setattr__(self, attr, [_cast(v) for v in value] if isinstance(value, list) else _cast(value))
            if not isinstance(self._defaults[attr], list):
                self._defaults[attr] = _cast(self._defaults[attr])
        for _, child in self._children():
            child.set_dtype(dst_type)
        self._computed = None
        self._bump_version()
        return self

    def _children(self) -> List:
        """The child metrics held as attributes, directly or in a list, tuple
        or dict, as ``(name, metric)``."""
        out = []
        for name, value in self.__dict__.items():
            if isinstance(value, Metric):
                out.append((name, value))
            elif isinstance(value, (list, tuple)):
                out.extend((f"{name}.{i}", v) for i, v in enumerate(value) if isinstance(v, Metric))
            elif isinstance(value, dict):
                out.extend((f"{name}.{k}", v) for k, v in value.items() if isinstance(v, Metric))
        return out

    def memory_snapshot(self, top_n: int = 10) -> Dict[str, Any]:
        """Bytes of state a leaf: ``{"total_bytes", "leaf_count", "leaves"}``
        with the ``top_n`` largest leaves as ``{"name", "shape", "dtype",
        "nbytes", "logical_nbytes"}``. A list state is one entry summing its
        elements (its shape is the element count). ``nbytes`` is what this
        process holds; ``logical_nbytes`` the whole leaf, larger only for a
        ``shard_state=`` leaf that holds a shard (``nbytes`` times N)."""
        sharded = self.sharded_axes()
        leaves: List[Dict[str, Any]] = []
        for name in self._defaults:
            current = getattr(self, name)
            if isinstance(current, list):
                nbytes = sum(v.nbytes for v in current)
                shape: tuple = (len(current),)
                dtype = dtype_name(current[0].dtype) if current else "empty-list"
            else:
                nbytes, shape, dtype = current.nbytes, tuple(current.shape), dtype_name(current.dtype)
            logical = nbytes
            if name in sharded and shape:
                full_d0 = int(self._defaults[name].shape[0])
                if 0 < shape[0] < full_d0 and full_d0 % shape[0] == 0:
                    logical = nbytes * (full_d0 // shape[0])
            leaves.append({"name": name, "shape": shape, "dtype": dtype, "nbytes": nbytes, "logical_nbytes": logical})
        leaves.sort(key=lambda leaf: (-leaf["nbytes"], leaf["name"]))
        return {
            "total_bytes": sum(leaf["nbytes"] for leaf in leaves),
            "leaf_count": len(leaves),
            "leaves": leaves[: max(0, int(top_n))],
        }

    def telemetry_snapshot(self) -> Dict[str, Any]:
        """The per-owner stats merged into one report, with the JAX package's
        keys (``metrics_tpu/metric.py:981``): ``owner``, ``dispatch``,
        ``sync``, ``forward``, ``resilience``, ``aot_cache``, ``memory``."""
        return {
            "owner": type(self).__name__,
            "dispatch": self.dispatch_stats,
            "sync": dict(self._sync_stats),
            "forward": self.forward_stats,
            "resilience": {
                "dispatch": self._dispatch_resilience.stats(),
                "forward": self._forward_resilience.stats(),
            },
            "aot_cache": aot_cache_stats(),
            "memory": self.memory_snapshot(),
        }

    # ----------------------------------------------------------- checkpoints
    def persistent(self, mode: bool = False) -> None:
        """Toggle persistence of all states."""
        for key in self._persistent:
            self._persistent[key] = mode

    def state_dict(self, destination: Optional[Dict] = None, prefix: str = "") -> Dict[str, Any]:
        """Copies of the persistent states (tensors on the metric's device),
        ``aux:<name>`` entries and ``__checksum__::<key>`` entries in the
        JAX package's format."""
        top_level = destination is None
        destination = {} if destination is None else destination
        for key in self._defaults:
            if not self._persistent[key]:
                continue
            current = getattr(self, key)
            destination[prefix + key] = [v.clone() for v in current] if isinstance(current, list) else current.clone()
        for name in self._aux_attributes:
            value = getattr(self, name, None)
            if value is not None:
                destination[f"{prefix}aux:{name}"] = value.value if isinstance(value, Enum) else value
        for name, child in self._children():
            child.state_dict(destination, prefix=f"{prefix}{name}.")
        if top_level:
            attach_checksums(destination)
        return destination

    def load_state_dict(self, state_dict: Dict[str, Any], prefix: str = "", strict: bool = True) -> None:
        """Restore states from :meth:`state_dict` (tensors or numpy arrays).

        The checksums are verified before any state is touched; a mismatch
        raises :class:`~metrics_tpu_torch.utilities.exceptions.StateCorruptionError`.
        """
        if not prefix:
            verify_checksums(state_dict)
        for key in self._defaults:
            name = prefix + key
            if name in state_dict:
                value = state_dict[name]
                if isinstance(value, (list, tuple)):
                    object.__setattr__(self, key, [_as_state(v, self._device) for v in value])
                else:
                    object.__setattr__(self, key, _as_state(value, self._device))
                self._update_count = max(self._update_count, 1)
            elif strict and self._persistent[key]:
                raise KeyError(f"Missing key {name!r} in state_dict")
        for name in self._aux_attributes:
            key = f"{prefix}aux:{name}"
            if key in state_dict:
                setattr(self, name, state_dict[key])
        self._computed = None
        self._bump_version()
        for name, child in self._children():
            child.load_state_dict(state_dict, prefix=f"{prefix}{name}.", strict=strict)

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """The kwargs this metric's ``update`` accepts (all of them if it takes ``**kwargs``)."""
        params = self._update_signature.parameters
        if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
            return kwargs
        var = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
        return {k: v for k, v in kwargs.items() if k in params and params[k].kind not in var}

    def __hash__(self) -> int:
        return hash((self.__class__.__name__, id(self)))

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}()"

    # Arithmetic on metrics builds a CompositionalMetric, as in the JAX
    # package, quirks included: ``+m`` is ``abs(m)``, ``-m`` is ``-abs(m)``,
    # and the reflected ``&``, ``|`` and ``^`` keep the metric on the left.
    # ``==`` gives a (truthy) metric, so compare metrics by identity (``is``)
    # or by key, never with ``==`` or ``in``.
    def __add__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.add, self, other)

    def __radd__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.add, other, self)

    def __sub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.sub, self, other)

    def __rsub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.sub, other, self)

    def __mul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.mul, self, other)

    def __rmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.mul, other, self)

    def __truediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.truediv, self, other)

    def __rtruediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.truediv, other, self)

    def __floordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.floordiv, self, other)

    def __rfloordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.floordiv, other, self)

    def __mod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.mod, self, other)

    def __rmod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.mod, other, self)

    def __pow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.pow, self, other)

    def __rpow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.pow, other, self)

    def __matmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.matmul, self, other)

    def __rmatmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.matmul, other, self)

    def __and__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.and_, self, other)

    def __rand__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.and_, self, other)

    def __or__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.or_, self, other)

    def __ror__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.or_, self, other)

    def __xor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.xor, self, other)

    def __rxor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.xor, self, other)

    def __lt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.lt, self, other)

    def __le__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.le, self, other)

    def __gt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.gt, self, other)

    def __ge__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.ge, self, other)

    def __eq__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(operator.eq, self, other)

    def __ne__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(operator.ne, self, other)

    def __abs__(self) -> "CompositionalMetric":
        return CompositionalMetric(operator.abs, self, None)

    def __neg__(self) -> "CompositionalMetric":
        return CompositionalMetric(_neg, self, None)

    def __pos__(self) -> "CompositionalMetric":
        return CompositionalMetric(operator.abs, self, None)

    def __inv__(self) -> "CompositionalMetric":
        return CompositionalMetric(operator.inv, self, None)

    __invert__ = __inv__

    def __getitem__(self, idx: Any) -> "CompositionalMetric":
        return CompositionalMetric(functools.partial(_getitem, idx=idx), self, None)

    # ``__getitem__`` never raises IndexError, so the sequence protocol would
    # make ``iter(metric)``, ``list(metric)`` and ``x in metric`` loop for
    # ever: a metric is not iterable (the JAX package loops here)
    __iter__ = None

    def __getnewargs__(self) -> tuple:
        return tuple()


def _neg(x: Tensor) -> Tensor:
    return -torch.abs(x)


def _getitem(x: Tensor, idx: Any) -> Tensor:
    return x[idx]


def _operand(x: Any, device: torch.device) -> Any:
    """A number or tensor operand as a tensor on the composition's device (a
    number in the JAX package's 32-bit dtypes); a metric or None as it is."""
    return _stable_default(x, device) if isinstance(x, (int, float, Tensor)) else x


class CompositionalMetric(Metric):
    """A metric built by arithmetic on metrics (and numbers or tensors):
    ``update``, ``forward``, ``reset`` and ``persistent`` reach the operand
    metrics, each with the kwargs its ``update`` accepts, and ``compute``
    applies the operator to their values. It holds no state of its own; it
    lives on its first operand metric's device.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Precision, Recall
        >>> p, r = Precision(device="cpu"), Recall(device="cpu")
        >>> f1 = 2 * p * r / (p + r)
        >>> f1.update(torch.tensor([0, 1, 1, 0]), torch.tensor([0, 1, 0, 0]))
        >>> float(f1.compute())
        0.75
    """

    full_state_update: Optional[bool] = True

    def __init__(
        self,
        operator: Callable,
        metric_a: Union[Metric, float, int, Tensor, None],
        metric_b: Union[Metric, float, int, Tensor, None],
    ) -> None:
        device = next((m.device for m in (metric_a, metric_b) if isinstance(m, Metric)), None)
        super().__init__(device=device)
        self.op = operator
        self.metric_a = _operand(metric_a, self.device)
        self.metric_b = _operand(metric_b, self.device)
        # tensor operands follow the metric to another device
        self._device_attributes = tuple(n for n in ("metric_a", "metric_b") if isinstance(getattr(self, n), Tensor))

    def update(self, *args: Any, **kwargs: Any) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.update(*args, **self.metric_a._filter_kwargs(**kwargs))
        if isinstance(self.metric_b, Metric):
            self.metric_b.update(*args, **self.metric_b._filter_kwargs(**kwargs))

    def compute(self) -> Any:
        val_a = self.metric_a.compute() if isinstance(self.metric_a, Metric) else self.metric_a
        val_b = self.metric_b.compute() if isinstance(self.metric_b, Metric) else self.metric_b
        if val_b is None:
            return self.op(val_a)
        return self.op(val_a, val_b)

    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None, env: Optional[DistEnv] = None,
                   exclude: Sequence[str] = ()) -> None:
        """No sync of its own: the operand metrics sync in their ``compute``."""

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        val_a = (
            self.metric_a(*args, **self.metric_a._filter_kwargs(**kwargs))
            if isinstance(self.metric_a, Metric)
            else self.metric_a
        )
        val_b = (
            self.metric_b(*args, **self.metric_b._filter_kwargs(**kwargs))
            if isinstance(self.metric_b, Metric)
            else self.metric_b
        )
        if val_a is None:
            self._forward_cache = None
        elif val_b is None:
            self._forward_cache = None if isinstance(self.metric_b, Metric) else self.op(val_a)
        else:
            self._forward_cache = self.op(val_a, val_b)
        return self._forward_cache

    def reset(self) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.reset()
        if isinstance(self.metric_b, Metric):
            self.metric_b.reset()

    def persistent(self, mode: bool = False) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.persistent(mode=mode)
        if isinstance(self.metric_b, Metric):
            self.metric_b.persistent(mode=mode)

    def __repr__(self) -> str:
        op = self.op.__name__ if hasattr(self.op, "__name__") else self.op
        return f"{self.__class__.__name__}(\n  {op}(\n    {self.metric_a!r},\n    {self.metric_b!r}\n  )\n)"

    def _wrap_update(self, update: Callable) -> Callable:
        return update

    def _wrap_compute(self, compute: Callable) -> Callable:
        return compute
