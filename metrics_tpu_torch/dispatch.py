"""Fast dispatch: an update as one captured program a shape bucket.

Port of ``metrics_tpu/dispatch.py:117-593``. The JAX package compiles each
``(static-flag key, input shape bucket, dtype, state layout)`` of an update
once and calls the executable directly; on Hopper the counterpart of that
executable is a **CUDA graph**: the host enqueues a whole update as one
``cudaGraphLaunch``, however many kernels it holds.

* **The cache key** is the JAX engine's: masked or not, the static key, the
  input layout, the inputs' shapes and dtypes (a masked input's first
  dimension is its bucket's), and the state leaves' shapes and dtypes.
* **Shape buckets.** Where the owner supports masked updates
  (``Metric._masked_update``), a batch of ``B >= 2`` rows is padded with
  zero rows to ``bucket_pow2(B)`` (at least :data:`MIN_BUCKET`), and the
  program gets the true row count ``n_valid`` as a device scalar: a mask
  built inside makes the padded rows no-ops, so batch sizes within one bucket
  share one program. Other owners get one program an exact shape.
* **A miss on the card** runs the program once eagerly, on a side stream and
  under the traced flag (:func:`~metrics_tpu_torch.utilities.checks.tracing`):
  this run serves the call, builds the kernel libraries, reads the device's
  limits and warms the allocator, so that none of that happens in the
  capture. Then it captures the program twice, as two ``torch.cuda.CUDAGraph``
  s that read static input buffers of the bucket's shape: one reads state
  buffer set A and writes its new state into set B, the other reads B and
  writes A. One memory pool serves a dispatcher's graphs.
* **A hit on the card** copies the batch into the static inputs (the rows
  past it keep what an earlier batch left there, which the mask drops), fills
  ``n_valid``, replays the graph that reads the set the owner's leaves are,
  and installs the other set as its leaves. A leaf that is neither (a
  default after ``reset``, a loaded checkpoint, another bucket's buffer) is
  copied into set A first, as the JAX engine copies a foreign buffer before
  it donates one (``dispatch.py:400``). So a call never writes the buffers
  its input leaves are, and a snapshot of them taken before it holds them
  by reference (:mod:`metrics_tpu_torch.resilience`); the call after next
  writes them again, so whatever holds a state tensor across updates holds
  a copy (``state()``, ``state_dict()``, a ``compute`` value,
  :func:`engine_owned`).
* **On the CPU** there is no graph: the same program (padding, mask, traced
  flag) runs directly, so the CPU tests pin the engine's semantics.
* The cache is an LRU bounded by ``METRICS_TPU_CACHE_MAX`` (default 256,
  ``0`` unlimited); ``stats`` counts ``dispatches``, ``retraces`` (programs
  built) and ``evictions``, and a build names its cause as the JAX engine
  does (:meth:`FastDispatcher._retrace_cause`).
* ``METRICS_TPU_FAST_DISPATCH=0`` turns the engine off: updates take the
  eager path, which still runs the kernels on the card.

A graph records the kernel launches its capture made
(:func:`metrics_tpu_torch.ops.registry.recording`) and counts them again on
each replay, so the registry's counts stay the kernels run on the card.

The JAX engine's persistent on-disk tier (``METRICS_TPU_AOT_CACHE``) is not
ported (ROADMAP.md, Queue A item 13): the port does not read that variable,
and every process captures its graphs anew. Its cost and hazard attributes
and telemetry spans come with observability (item 10).
"""
import gc
import os
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch import faults
from metrics_tpu_torch.ops import registry
from metrics_tpu_torch.utilities.checks import tracing
from metrics_tpu_torch.utilities.data import bucket_pow2, pad_axis0

MIN_BUCKET = 8

# every cached graph's state buffers, by id: the tensors a later replay writes in place
_OWNED: "weakref.WeakValueDictionary[int, Tensor]" = weakref.WeakValueDictionary()


def fast_dispatch_enabled() -> bool:
    """Kill switch (env ``METRICS_TPU_FAST_DISPATCH``, default on)."""
    return os.environ.get("METRICS_TPU_FAST_DISPATCH", "1").lower() not in ("0", "false", "off")


def cache_max() -> int:
    """Programs a dispatcher keeps (env ``METRICS_TPU_CACHE_MAX``, default 256, 0 = unlimited)."""
    try:
        return int(os.environ.get("METRICS_TPU_CACHE_MAX", "256"))
    except ValueError:
        return 256


def engine_owned(t: Any) -> bool:
    """Whether ``t`` is a state buffer that a later replay of some
    dispatcher's graph writes in place: whatever holds it across an update
    holds a copy."""
    return isinstance(t, Tensor) and _OWNED.get(id(t)) is t


def copy_tensors(value: Any, which: Callable[[Tensor], bool] = lambda t: True) -> Any:
    """``value`` (nested tuples, lists and dicts) with each tensor that
    ``which`` selects copied."""
    leaves, layout = _flatten(value)
    return _unflatten(layout, [v.clone() if isinstance(v, Tensor) and which(v) else v for v in leaves])


class FastDispatchUnsupported(Exception):
    """Inputs or an owner the engine cannot serve; the caller takes the eager path."""


def _flatten(tree: Any) -> Tuple[List[Any], Any]:
    """The leaves of nested tuples, lists and dicts, and a hashable layout."""
    leaves: List[Any] = []

    def walk(x: Any) -> Any:
        if isinstance(x, (tuple, list)):
            return (type(x) is tuple, tuple(walk(v) for v in x))
        if isinstance(x, dict):
            return (tuple(x), tuple(walk(v) for v in x.values()))
        leaves.append(x)
        return None

    return leaves, walk(tree)


def _unflatten(layout: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(node: Any) -> Any:
        if node is None:
            return next(it)
        head, children = node
        if isinstance(head, bool):
            seq = [build(c) for c in children]
            return tuple(seq) if head else seq
        return {k: build(c) for k, c in zip(head, children)}

    return build(layout)


def _aval(x: Tensor, rows: Optional[int] = None) -> Tuple:
    shape = tuple(x.shape) if rows is None or x.ndim == 0 else (rows,) + tuple(x.shape[1:])
    return shape, x.dtype, x.device


class _Program:
    """One cache entry: the program, and on the card its graph and buffers."""

    __slots__ = ("masked", "body", "graphs", "inputs", "n_valid", "filled_n_valid", "counts", "sets", "values",
                 "launched")

    def __init__(self, masked: bool, body: Callable) -> None:
        self.masked = masked
        self.body = body  # (n_valid, counts, leaves, inputs) -> (new leaves, batch value)
        # on the card: graphs[i] reads state set sets[i] and writes sets[1 - i]; its batch value is values[i]
        self.graphs: Tuple[torch.cuda.CUDAGraph, ...] = ()
        self.sets: Tuple[Tuple[Tensor, ...], ...] = ()
        self.values: List[Any] = []
        self.launched: List[Tuple[str, str, Tuple[int, ...]]] = []  # the kernel launches of one replay
        self.inputs: List[Tensor] = []
        self.n_valid: Optional[Tensor] = None
        self.filled_n_valid: Optional[int] = None
        self.counts: Optional[Tensor] = None


class FastDispatcher:
    """One owner's program cache. A ``Metric`` or a ``MetricCollection`` wires
    itself in through closures, as in the JAX package.

    Args:
        label: the owner's name (a metric's class name, or ``"MetricCollection"``).
        device: where the owner's states live.
        read_leaves / write_leaves: the owner's state leaves, as a tuple, read
            straight off its attributes / installed there.
        make_update: ``(static_kwargs) -> fn(leaves, *args, **dyn) -> leaves``.
        make_masked_update: the same as ``fn(n_valid, leaves, *args, **dyn)``;
            ``None`` where the owner has no masked update.
        masking_ok: ``() -> bool``: whether the owner's configuration masks.
        stats: the owner's ``dispatches``/``retraces`` counters.
        make_forward / make_masked_forward: ``fn(counts, [n_valid,] leaves,
            *args, **dyn) -> (leaves, batch_value)``, the fused forward.
        forward_stats: the owner's ``launches``/``retraces``/``engine_us`` counters.
        make_scan: ``fn(leaves, *stacked_args, **stacked_dyn) -> leaves``, a
            fold over a stack of batches.
    """

    def __init__(
        self,
        label: str,
        device: torch.device,
        read_leaves: Callable[[], Tuple],
        write_leaves: Callable[[Tuple], None],
        make_update: Callable[[Dict], Callable],
        make_masked_update: Optional[Callable[[Dict], Callable]] = None,
        masking_ok: Optional[Callable[[], bool]] = None,
        stats: Optional[Dict[str, int]] = None,
        make_forward: Optional[Callable[[Dict], Callable]] = None,
        make_masked_forward: Optional[Callable[[Dict], Callable]] = None,
        forward_stats: Optional[Dict[str, Any]] = None,
        make_scan: Optional[Callable[[Dict], Callable]] = None,
    ) -> None:
        self.label = label
        self.device = torch.device(device)
        self._read_leaves = read_leaves
        self._write_leaves = write_leaves
        self._factories = {
            ("update", False): make_update,
            ("update", True): make_masked_update,
            ("forward", False): make_forward,
            ("forward", True): make_masked_forward,
            ("scan", False): make_scan,
        }
        self._masking_ok = masking_ok or (lambda: False)
        self.stats = stats if stats is not None else {"dispatches": 0, "retraces": 0}
        self.forward_stats = (
            forward_stats if forward_stats is not None else {"launches": 0, "retraces": 0, "engine_us": 0.0}
        )
        self._cache: "OrderedDict[Tuple, _Program]" = OrderedDict()
        self._pool: Any = None
        self._side_stream: Optional[torch.cuda.Stream] = None
        self._nvalid_cpu: Dict[int, Tensor] = {}
        self._last_out: Tuple[Tuple, Tuple] = ((), ())  # (leaves the last call gave, their avals)
        # builds by (family, cause), the cause as _retrace_cause names it
        self.causes: Dict[Tuple[str, str], int] = {}
        # per family, the static keys / input shapes / dtypes already built: a miss's cause
        self._seen: Dict[str, Dict[str, set]] = {
            f: {"static": set(), "shapes": set(), "dtypes": set()} for f in ("update", "forward", "scan")
        }

    # ------------------------------------------------------------ entry points
    def update(self, static: Dict, static_key: Tuple, args: Tuple, dyn_kwargs: Dict) -> None:
        """One update through a cached program (built on a miss); the new
        state leaves are installed on the owner."""
        out, _ = self._call("update", static, static_key, self._read_leaves(), args, dyn_kwargs)
        self.stats["dispatches"] += 1
        self._write_leaves(faults.maybe_corrupt_leaves(out))

    def forward(self, counts: Any, static: Dict, static_key: Tuple, args: Tuple, dyn_kwargs: Dict) -> Any:
        """One fused forward (state advance and batch value) through a cached
        program. ``counts`` (a number, or a dict of them for a collection) are
        the merge counts, carried as device scalars so that a growing count
        builds nothing. Returns the batch value, copied out of the graph."""
        if self._factories[("forward", False)] is None:
            raise FastDispatchUnsupported("owner wired no forward program factory")
        t0 = time.perf_counter()
        out, value = self._call("forward", static, static_key, self._read_leaves(), args, dyn_kwargs, counts)
        self.forward_stats["launches"] += 1
        self.forward_stats["engine_us"] += (time.perf_counter() - t0) * 1e6
        self._write_leaves(faults.maybe_corrupt_leaves(out))
        return value

    def scan(self, static: Dict, static_key: Tuple, leaves: Tuple, args: Tuple, dyn_kwargs: Dict) -> Tuple:
        """Fold a stack of batches into ``leaves`` through one cached program
        a (stack, batch) shape; returns new leaves that nothing else holds."""
        out, _ = self._call("scan", static, static_key, leaves, args, dyn_kwargs)
        return tuple(x.clone() for x in out) if self.device.type == "cuda" else out

    # ------------------------------------------------------------------ core
    def _call(self, family: str, static: Dict, static_key: Tuple, leaves: Tuple, args: Tuple, dyn_kwargs: Dict,
              counts: Any = None) -> Tuple[Tuple, Any]:
        flat, layout = _flatten((args, dyn_kwargs))
        flat = [self._canonicalize(x) for x in flat]
        batch = self._uniform_batch(flat)
        masked = (
            self._factories.get((family, True)) is not None
            # a 1-row batch can meet squeeze-style formatting whose meaning changes with the padded length
            and batch is not None
            and batch >= 2
            and self._masking_ok()
        )
        rows = bucket_pow2(batch, minimum=MIN_BUCKET) if masked else None
        if faults.any_active():
            faults.check_oom(sum(x.element_size() * int(np.prod(_aval(x, rows)[0])) for x in flat), self.label)
            flat = faults.maybe_poison(flat)
        for leaf in leaves:
            if not isinstance(leaf, Tensor):
                raise FastDispatchUnsupported(f"non-tensor state leaf of type {type(leaf).__name__}")
        count_values, count_layout = _flatten(counts) if counts is not None else ([], None)
        leaf_avals = self._leaf_avals(leaves)
        key = (family, masked, static_key, layout, count_layout, tuple(_aval(x, rows) for x in flat), leaf_avals)

        program = self._cache.get(key)
        served = None
        if program is None:
            faults.check("compile", self.label)
            cause = self._retrace_cause(family, static_key, [_aval(x, rows) for x in flat])
            fn = self._factories[(family, masked)](dict(static))
            program, served = self._build(fn, family, masked, layout, count_layout, leaves, flat, batch, rows,
                                          count_values)
            self.causes[(family, cause)] = self.causes.get((family, cause), 0) + 1
            if family == "update":
                self.stats["retraces"] += 1
            elif family == "forward":
                self.forward_stats["retraces"] += 1
            self._cache_put(key, program)
        else:
            self._cache.move_to_end(key)
        faults.check("launch", self.label)
        if served is not None:
            out = served
        elif not program.graphs:
            out = self._run_direct(program, leaves, flat, batch, rows, count_values)
        else:
            src = self._stage(program, leaves, flat, batch, count_values)
            program.graphs[src].replay()
            registry.note_replay(program.launched)
            out = program.sets[1 - src], copy_tensors(program.values[src])
        self._last_out = (out[0], leaf_avals)
        return out

    def _leaf_avals(self, leaves: Tuple) -> Tuple:
        """The leaves' shapes and dtypes, read off the last call's output where
        the leaves are that output (the steady state)."""
        last, avals = self._last_out
        if len(last) == len(leaves) and all(a is b for a, b in zip(leaves, last)):
            return avals
        return tuple(_aval(x) for x in leaves)

    def _body(self, fn: Callable, family: str, masked: bool, layout: Any, count_layout: Any) -> Callable:
        """The program as a function of its tensors: ``(n_valid, counts,
        leaves, inputs) -> (new leaves, batch value)``."""

        def body(n_valid, counts, leaves, inputs):
            args, dyn = _unflatten(layout, inputs)
            lead = (n_valid,) if masked else ()
            if family == "forward":
                new, value = fn(_unflatten(count_layout, counts), *lead, tuple(leaves), *args, **dyn)
                return tuple(new), value
            return tuple(fn(*lead, tuple(leaves), *args, **dyn)), None

        return body

    def _run_direct(self, program, leaves, flat, batch, rows, count_values):
        """The program run as it is, with no graph: on the CPU."""
        inputs = [pad_axis0(x, rows) for x in flat] if program.masked else flat
        n_valid = None
        if program.masked:
            n_valid = self._nvalid_cpu.get(batch)
            if n_valid is None:
                n_valid = self._nvalid_cpu[batch] = torch.tensor(batch, dtype=torch.int32, device=self.device)
        counts = [torch.tensor(float(c), dtype=torch.float32, device=self.device) for c in count_values]
        with tracing():
            new, value = program.body(n_valid, counts, leaves, inputs)
        self._check_layout(new, leaves)
        return new, value

    def _build(self, fn, family, masked, layout, count_layout, leaves, flat, batch, rows, count_values):
        """A new cache entry; on the card also the result of this call (from
        the warm-up run), else ``None``."""
        body = self._body(fn, family, masked, layout, count_layout)
        program = _Program(masked, body)
        if self.device.type != "cuda":
            return program, None
        dev = self.device
        program.inputs = [
            torch.zeros(_aval(x, rows)[0], dtype=x.dtype, device=dev) if masked and x.ndim else torch.empty_like(x)
            for x in flat
        ]
        program.sets = tuple(tuple(torch.empty_like(leaf) for leaf in leaves) for _ in range(2))
        program.n_valid = torch.zeros((), dtype=torch.int32, device=dev) if masked else None
        program.counts = torch.zeros(len(count_values), dtype=torch.float32, device=dev) if count_values else None
        counts = list(program.counts) if count_values else []
        self._stage(program, leaves, flat, batch, count_values)  # into set A

        def run(src: int) -> Any:
            new, value = body(program.n_valid, counts, program.sets[src], program.inputs)
            self._check_layout(new, leaves)
            torch._foreach_copy_(list(program.sets[1 - src]), list(new))  # a few kernels, not one copy a leaf
            return value

        # the warm-up: PyTorch's side-stream run before a capture, which also serves this call
        current = torch.cuda.current_stream(dev)
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(dev)
        side = self._side_stream
        side.wait_stream(current)
        with torch.cuda.stream(side), tracing():
            served_value = copy_tensors(run(0))
        current.wait_stream(side)
        for v in _flatten(served_value)[0]:
            if isinstance(v, Tensor):
                v.record_stream(current)

        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graphs = []
        # no garbage collection while capturing: a graph freed then (an unreferenced metric's) could not be
        # destroyed during the capture, which it would invalidate
        collecting = gc.isenabled()
        gc.disable()
        try:
            for src in (0, 1):  # a capture runs nothing: set B keeps the warm-up's result
                graph = torch.cuda.CUDAGraph()
                with registry.recording() as launched, tracing(), torch.cuda.graph(graph, pool=self._pool):
                    program.values.append(run(src))
                graphs.append(graph)
        finally:
            if collecting:
                gc.enable()
        program.graphs, program.launched = tuple(graphs), launched
        return program, (program.sets[1], served_value)

    def _stage(self, program: _Program, leaves: Tuple, flat: List[Tensor], batch: Optional[int],
               count_values: List[Any]) -> int:
        """Copy this call's batch, row count and merge counts into the graphs'
        buffers, and its state where it is not a buffer set already; returns
        the set the replay reads (0 for A, 1 for B)."""
        src = 1 if all(a is b for a, b in zip(leaves, program.sets[1])) else 0
        if src == 0:
            for buf, leaf in zip(program.sets[0], leaves):
                if leaf is not buf:
                    buf.copy_(leaf)
        for buf, x in zip(program.inputs, flat):
            if program.masked and x.ndim:
                buf[:x.shape[0]].copy_(x)  # the rows past it: an earlier batch's, dropped by the mask
            else:
                buf.copy_(x)
        if program.masked and program.filled_n_valid != batch:  # a steady batch size fills it once
            program.n_valid.fill_(batch)
            program.filled_n_valid = batch
        if count_values:
            if len(set(count_values)) == 1:
                program.counts.fill_(float(count_values[0]))
            else:
                for slot, c in zip(program.counts, count_values):
                    slot.fill_(float(c))
        return src

    @staticmethod
    def _check_layout(new: Tuple, leaves: Tuple) -> None:
        if len(new) != len(leaves) or any(
            not isinstance(a, Tensor) or a.shape != b.shape or a.dtype != b.dtype for a, b in zip(new, leaves)
        ):
            raise FastDispatchUnsupported("the update changes the shape or dtype of a state leaf")

    # --------------------------------------------------------------- helpers
    def _canonicalize(self, x: Any) -> Tensor:
        """An input as a tensor on the owner's device; numbers and numpy
        arrays in the JAX package's 32-bit dtypes."""
        if isinstance(x, Tensor):
            if x.device != self.device:
                raise RuntimeError(f"{self.label}: an input on {x.device}, the states on {self.device}")
            return x
        if isinstance(x, (np.ndarray, np.number, int, float)) and not isinstance(x, bool):
            arr = np.asarray(x)
            if arr.dtype == np.float64:
                arr = arr.astype(np.float32)
            elif arr.dtype == np.int64:
                arr = arr.astype(np.int32)
            return torch.from_numpy(np.array(arr)).to(self.device)  # a copy, 0-d stays 0-d
        raise FastDispatchUnsupported(f"non-tensor update input of type {type(x).__name__}")

    @staticmethod
    def _uniform_batch(flat: List[Tensor]) -> Optional[int]:
        """The dim-0 length every non-scalar input shares, else None."""
        sizes = {int(x.shape[0]) for x in flat if x.ndim >= 1}
        return sizes.pop() if len(sizes) == 1 else None

    def _cache_put(self, key: Tuple, program: _Program) -> None:
        self._cache[key] = program
        for buf in (b for bufs in program.sets for b in bufs):
            _OWNED[id(buf)] = buf
        limit = cache_max()
        while limit > 0 and len(self._cache) > limit:
            _, evicted = self._cache.popitem(last=False)
            for buf in (b for bufs in evicted.sets for b in bufs):
                _OWNED.pop(id(buf), None)
            self.stats["evictions"] = self.stats.get("evictions", 0) + 1

    def _retrace_cause(self, family: str, static_key: Tuple, avals: List[Tuple]) -> str:
        """Why this miss builds a program: the first part of the key (static
        flags, then input shapes, then input dtypes) this family never built
        before; ``new-signature`` for the rest (state layout, input layout)."""
        shapes = tuple(a[0] for a in avals)
        dtypes = tuple(str(a[1]) for a in avals)
        seen = self._seen[family]
        if not seen["static"] and not seen["shapes"]:
            cause = "first-compile"
        elif static_key not in seen["static"]:
            cause = "new-static-key"
        elif shapes not in seen["shapes"]:
            cause = "new-shape-bucket"
        elif dtypes not in seen["dtypes"]:
            cause = "new-dtype"
        else:
            cause = "new-signature"
        seen["static"].add(static_key)
        seen["shapes"].add(shapes)
        seen["dtypes"].add(dtypes)
        return cause
