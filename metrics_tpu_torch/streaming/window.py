"""Windowed metric wrappers: bounded-memory metrics over continuous traffic.

Port of ``metrics_tpu/streaming/window.py``. Every base metric accumulates
without bound, right for a finite evaluation set and wrong for monitoring,
where "accuracy" means "accuracy over the last hour". The wrappers bound the
horizon and the memory with fixed-shape states, so they stay eligible for the
engines (``jit_update=True``, the default: a tick is one CUDA graph replay on
the card) and never build a new program as the window slides:

* :class:`SlidingWindow`: a ring of ``window // slide`` per-bucket states of
  the inner metric, with a cached left fold of the frozen buckets (``pfx_*``)
  so that a read is one ``pure_merge``; :class:`FoldTreeWindow` adds
  sub-range reads over a host-side sparse table of folds.
* :class:`ResolutionLadder`: cascading rings, minute to hour to day.
* :class:`TumblingWindow`: non-overlapping windows of ``window`` updates.
* :class:`ExponentialDecay`: every state scaled by ``0.5 ** (1 / halflife)``
  before each update.

Each holds the inner metric's states as its own (``ring_``, ``lvl<l>_``,
``cur_``/``done_``, ``ew_``), declared with the inner state's reduction, so
they sync and checkpoint like any state.

**Branches.** The JAX package picks its path by ``isinstance(x,
jax.core.Tracer)``: eagerly it skips the prefix refold when the cursor did not
move (``bool(adv)``, a host read) and reads the cached fold; under a tracer
the refold, the cached read and the ladder's cascades are ``lax.cond``. Here
"traced" is :func:`~metrics_tpu_torch.utilities.checks._is_traced`: an
engine's program (its eager miss run and its CUDA graph capture), or
``fused_window_tick``. A CUDA graph has no branches, so a traced tick computes
both sides and selects with ``torch.where``, as the JAX package's ``cond``
lowers under ``vmap``: every captured tick pays the refold (``num_buckets -
1`` merges) whether or not the window advanced. Both paths run the same
float32 merges in the same order, so they give the same bits. Folds of
states that are all integer sums, maxima or minima (whose result does not
depend on the order) are one masked reduction per state; any float state
keeps the left fold, bucket by bucket, oldest first.

Not ported yet: the telemetry events (ROADMAP.md, Queue A item 10), and the
opt-in fused tick inside ``SlidingWindow.update``
(``metrics_tpu/streaming/window.py:374-384``, behind
``METRICS_TPU_FORCE_PALLAS``): the port has no opt-in switch, and
:func:`metrics_tpu_torch.ops.fused_window_tick` is called on its own.
"""
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.metric import Metric, resolve_device
from metrics_tpu_torch.utilities.checks import _is_traced
from metrics_tpu_torch.utilities.data import dim_zero_max, dim_zero_mean, dim_zero_min, dim_zero_sum, dtype_name
from metrics_tpu_torch.utilities.exceptions import MetricsUserError

__all__ = [
    "SlidingWindow",
    "FoldTreeWindow",
    "ResolutionLadder",
    "TumblingWindow",
    "ExponentialDecay",
]

State = Dict[str, Tensor]
# the reductions whose fold over integer states does not depend on the order of the buckets
_ORDER_FREE = (dim_zero_sum, dim_zero_max, dim_zero_min)


def _describe(metric: Metric) -> str:
    """A stable description of the inner metric's configuration: its class,
    public scalar attributes and state layouts (the inner metric itself sits
    under an underscore attribute)."""
    parts = [f"{type(metric).__module__}.{type(metric).__qualname__}"]
    for k in sorted(vars(metric)):
        if k.startswith("_"):
            continue
        v = getattr(metric, k)
        if isinstance(v, (bool, int, float, str, type(None))):
            parts.append(f"{k}={v!r}")
    for k in sorted(metric._defaults):
        d = metric._defaults[k]
        if isinstance(d, list):
            parts.append(f"{k}:list")
        else:
            parts.append(f"{k}:{tuple(d.shape)}/{dtype_name(d.dtype)}")
    return ";".join(parts)


def _check_inner(metric: Any, wrapper: str, allow_max_min: bool = True) -> None:
    if not isinstance(metric, Metric):
        raise MetricsUserError(f"{wrapper} expects a Metric instance, got {type(metric).__name__}")
    if getattr(type(metric), "host_only", False):
        raise MetricsUserError(
            f"{wrapper} cannot wrap host_only metric {type(metric).__name__}: "
            "windowing needs a traceable pure_update"
        )
    for name, default in metric._defaults.items():
        if isinstance(default, list):
            raise MetricsUserError(
                f"{wrapper} cannot wrap {type(metric).__name__}: state {name!r} is a "
                "list state (unbounded, cannot stack into a fixed-shape ring). "
                "See docs/streaming.md for bounded-memory alternatives (sketches)."
            )
    if not allow_max_min:
        for name, red in metric._reductions.items():
            if red in (dim_zero_max, dim_zero_min):
                raise MetricsUserError(
                    f"ExponentialDecay cannot wrap {type(metric).__name__}: state "
                    f"{name!r} uses a max/min reduction, and decaying an extremum "
                    "is not meaningful. Use SlidingWindow instead."
                )


def _poison_token(stacked: Tensor) -> Tensor:
    """Reduction of ``pfx_token``: any merge of states across processes
    poisons the token to ``-1`` (merged prefixes mean nothing), so that the
    next read rebuilds the prefix cache. A module function, not a lambda, so
    that the wrapper pickles."""
    return stacked[0] * 0 - 1


def _rows(mask: Tensor, like: Tensor) -> Tensor:
    """A ``(n,)`` mask shaped to select whole rows of the ``(n, ...)`` tensor ``like``."""
    return mask.reshape(mask.shape + (1,) * (like.ndim - 1))


def _live(gate: Optional[Tensor]) -> Union[int, Tensor]:
    """1 for an update, the 0-d int32 gate for a masked one."""
    return 1 if gate is None else gate.to(torch.int32)


class _StreamingWindow(Metric):
    """Shared plumbing: the inner metric's checks, its defaults on the
    window's device, and its masked-update support.

    The window lives on the inner metric's device; ``device=`` may name it
    again, and any other device raises. ``gate`` arguments below are ``None``
    for an update (every row live) and a 0-d bool for a masked one (any row
    live), so an update pays no selects for a gate it does not have.
    """

    # the batch value is the inner metric's value on this batch alone: forward's double update
    full_state_update = True
    is_differentiable = False

    def __init__(self, metric: Metric, *, jit_update: bool = True, **kwargs: Any) -> None:
        if not isinstance(metric, Metric):
            raise MetricsUserError(
                f"{type(self).__name__} expects a Metric instance, got {type(metric).__name__}"
            )
        device = kwargs.pop("device", None)
        if device is not None and resolve_device(device) != metric.device:
            raise MetricsUserError(
                f"{type(self).__name__} on {resolve_device(device)} cannot wrap a metric on {metric.device}:"
                " build the inner metric on the window's device"
            )
        super().__init__(device=metric.device, jit_update=jit_update, **kwargs)
        self._inner = metric
        self.inner_spec = _describe(metric)
        self._inner_names = tuple(metric._defaults)
        self._inner_defaults = {k: v.clone() if isinstance(v, Tensor) else [] for k, v in metric._defaults.items()}
        # the engine of ops.window_tick.fused_window_tick, built at its first call
        self._fused_tick: Any = None

    def _masked_update_supported(self) -> bool:
        return self._inner._masked_update_supported()

    # -------------------------------------------------------------- folds
    def _fresh(self) -> State:
        """A copy of the inner defaults: a fold's seed."""
        return {k: d.clone() for k, d in self._inner_defaults.items()}

    def _zero_seen(self) -> Tensor:
        return torch.zeros((), dtype=torch.int32, device=self.device)

    def _fold_step(self, carry: Tuple[State, Tensor], xs: Tuple[State, Tensor]) -> Tuple[Tuple[State, Tensor], None]:
        """One step of the oracle fold: merge a bucket iff it holds updates,
        with ``count`` the nonempty buckets folded so far (the running-mean
        merge then weighs each bucket equally, and a count of 1 on the first
        live bucket drops the fold's default seed exactly)."""
        acc, seen = carry
        bucket, c = xs
        nonempty = c > 0
        seen_new = seen + nonempty.to(torch.int32)
        merged = self._inner.pure_merge(acc, bucket, count=seen_new.clamp(min=1).to(torch.float32))
        acc = {k: torch.where(nonempty, merged[k], acc[k]) for k in acc}
        return (acc, seen_new), None

    def _order_free(self) -> bool:
        """Whether every inner state is an integer sum, max or min, whose
        fold is the same for any order of the buckets."""
        return all(
            not d.is_floating_point() and not d.is_complex() and d.dtype != torch.bool
            and self._inner._reductions[k] in _ORDER_FREE
            for k, d in self._inner_defaults.items()
        )

    def _fold(self, carry: Tuple[State, Tensor], buckets: State, counts: Tensor) -> Tuple[State, Tensor]:
        """Continue the oracle fold over the ``(m, ...)`` stacked ``buckets``
        (oldest first) and their ``(m,)`` update counts."""
        acc, seen = carry
        if self._order_free():
            nonempty = counts > 0
            out = {}
            for k, a in acc.items():
                b, red = buckets[k], self._inner._reductions[k]
                if red is dim_zero_sum:
                    out[k] = a + torch.where(_rows(nonempty, b), b, 0).sum(dim=0, dtype=a.dtype)
                elif red is dim_zero_max:
                    out[k] = torch.maximum(a, torch.where(_rows(nonempty, b), b, a).amax(dim=0))
                else:
                    out[k] = torch.minimum(a, torch.where(_rows(nonempty, b), b, a).amin(dim=0))
            return out, seen + nonempty.sum(dtype=torch.int32)
        carry = (acc, seen)
        for j in range(counts.shape[0]):
            carry, _ = self._fold_step(carry, ({k: b[j] for k, b in buckets.items()}, counts[j]))
        return carry

    # --------------------------------------------------------------- device
    def to(self, device: Union[str, torch.device]) -> "_StreamingWindow":
        """Move the states, the inner metric and its defaults to ``device``."""
        super().to(device)
        self._inner_defaults = {k: v.to(self.device) for k, v in self._inner_defaults.items()}
        self._fused_tick = None  # its graph and buffers are for the old device
        return self

    def __getstate__(self) -> Dict[str, Any]:
        # a copy captures its own fused tick: it never shares a graph or its buffers with its source
        state = super().__getstate__()
        state.pop("_fused_tick", None)
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        super().__setstate__(state)
        self._fused_tick = None

    def __repr__(self) -> str:
        return f"{type(self).__name__}({type(self._inner).__name__}())"


class SlidingWindow(_StreamingWindow):
    """Evaluate ``metric`` over the most recent ``window`` updates.

    The state is a ring of ``window // slide`` buckets; each bucket is one
    partial inner state covering up to ``slide`` consecutive updates. An
    update folds the batch into the current bucket through the inner
    ``pure_update``; when the bucket holds ``slide`` updates the cursor moves
    on and the oldest bucket is cleared to the inner defaults. The cursor is
    a device scalar, so every tick is one program of fixed shape.

    ``compute()`` left-folds the buckets oldest-first through the inner
    ``pure_merge``, so for sum, max and min states the value is bit-equal to a
    fresh metric fed the same updates (mean states get a bucket-weighted
    running mean, exact when buckets are equally full). Between advances it
    covers between ``window - slide + 1`` and ``window`` updates.

    **Reads are one merge.** The ``pfx_*`` states hold the oracle fold of the
    ``n - 1`` frozen buckets, ``pfx_seen`` the nonempty buckets it absorbed,
    and ``pfx_token``/``advances`` its validity: a read merges the prefix with
    the live bucket, the fold's own last step. An advance refolds the prefix
    inside the tick. A merge across processes poisons ``pfx_token``
    (``_poison_token``) and the next eager read rebuilds; a traced read
    computes the cached and the full fold and selects.

    Args:
        metric: the inner metric; tensor states only.
        window: horizon in updates, a positive multiple of ``slide``.
        slide: advance granularity in updates (default 1: the exact horizon).
        shard_state: a process group (or ``"world"``) over which the ring's
            bucket axis is sharded by ``pure_sync`` (each rank holds
            ``num_buckets / N`` buckets); the bookkeeping states stay whole.
        jit_update: run ticks through the engine (default on).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SumMetric
        >>> from metrics_tpu_torch.streaming import SlidingWindow
        >>> w = SlidingWindow(SumMetric(device="cpu"), window=2, jit_update=False)
        >>> for v in (1.0, 2.0, 4.0):
        ...     w.update(torch.tensor(v))
        >>> float(w.compute())  # sum over the last 2 updates
        6.0
    """

    def __init__(
        self,
        metric: Metric,
        *,
        window: int,
        slide: int = 1,
        shard_state: Any = None,
        jit_update: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(metric, jit_update=jit_update, **kwargs)
        _check_inner(metric, "SlidingWindow")
        window, slide = int(window), int(slide)
        if window <= 0 or slide <= 0 or window % slide != 0:
            raise MetricsUserError(
                f"window must be a positive multiple of slide, got window={window} slide={slide}"
            )
        self.window = window
        self.slide = slide
        self.num_buckets = window // slide
        for k, d in self._inner_defaults.items():
            self.add_state(
                f"ring_{k}",
                d[None].expand((self.num_buckets,) + tuple(d.shape)),
                dist_reduce_fx=metric._reductions[k],
                shard_state=shard_state,
            )
        # replicas in lockstep hold the same bucket alignment: counts sum, cursors agree
        self.add_state("cursor", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="max")
        self.add_state("in_bucket", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="max")
        self.add_state("counts", torch.zeros((self.num_buckets,), dtype=torch.int32), dist_reduce_fx="sum")
        # the read cache: the oracle fold of the n - 1 frozen buckets; a fresh state is born valid
        for k, d in self._inner_defaults.items():
            self.add_state(f"pfx_{k}", d, dist_reduce_fx=metric._reductions[k])
        self.add_state("pfx_seen", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="max")
        self.add_state("advances", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="max")
        self.add_state("pfx_token", torch.tensor(0, dtype=torch.int32), dist_reduce_fx=_poison_token)

    # ------------------------------------------------------------- advance
    def _positions(self) -> Tensor:
        return torch.arange(self.num_buckets, dtype=torch.int32, device=self.device)

    def _advance(self, gate: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
        """Move the cursor when the current bucket is full (and the step is
        live) and clear the bucket it lands on: selects on device scalars."""
        adv = self.in_bucket >= self.slide
        if gate is not None:
            adv = adv & gate
        cursor = torch.where(adv, (self.cursor + 1) % self.num_buckets, self.cursor)
        cleared = adv & (self._positions() == cursor)
        self.counts = self.counts.masked_fill(cleared, 0)
        for k in self._inner_names:
            ring = getattr(self, f"ring_{k}")
            setattr(self, f"ring_{k}", torch.where(_rows(cleared, ring), self._inner_defaults[k], ring))
        self.cursor = cursor
        self.in_bucket = self.in_bucket.masked_fill(adv, 0)
        self._maintain_prefix(adv)
        return adv, cursor

    # ---------------------------------------------------------- read cache
    def _fold_positions(self, order: Tensor) -> Tuple[State, Tensor]:
        """The oracle left fold over the given ring positions, oldest first."""
        buckets = {k: getattr(self, f"ring_{k}").index_select(0, order) for k in self._inner_names}
        return self._fold((self._fresh(), self._zero_seen()), buckets, self.counts.index_select(0, order))

    def _prefix_fold(self) -> Tuple[State, Tensor]:
        """The fold of the n - 1 frozen buckets: the oracle fold less its last
        step (the cursor's bucket)."""
        n = self.num_buckets
        return self._fold_positions((self.cursor + 1 + self._positions()[: n - 1]) % n)

    def _install_prefix(self, acc: State, seen: Tensor) -> None:
        for k in self._inner_names:
            setattr(self, f"pfx_{k}", acc[k])
        self.pfx_seen = seen
        self.pfx_token = self.advances

    def _maintain_prefix(self, adv: Tensor) -> None:
        """Keep the prefix cache coherent across an advance. Eagerly the
        refold runs only when the cursor moved (one host read); traced, it
        runs every tick and a select keeps it where the cursor stayed."""
        advances = self.advances + adv.to(torch.int32)
        self.advances = advances
        if not _is_traced():
            if bool(adv):
                self._install_prefix(*self._prefix_fold())
            return
        acc, seen = self._prefix_fold()
        for k in self._inner_names:
            setattr(self, f"pfx_{k}", torch.where(adv, acc[k], getattr(self, f"pfx_{k}")))
        self.pfx_seen = torch.where(adv, seen, self.pfx_seen)
        # a poisoned (-1) token stays poisoned until a refold repairs it
        self.pfx_token = torch.where(adv, advances, self.pfx_token)

    def _bucket_at(self, cursor: Tensor) -> State:
        idx = cursor.reshape(1)
        return {k: getattr(self, f"ring_{k}").index_select(0, idx)[0] for k in self._inner_names}

    def _apply_bucket(self, cursor: Tensor, new_bucket: State, gate: Optional[Tensor]) -> None:
        at = self._positions() == cursor
        if gate is not None:
            at = at & gate
        for k in self._inner_names:
            ring = getattr(self, f"ring_{k}")
            setattr(self, f"ring_{k}", torch.where(_rows(at, ring), new_bucket[k], ring))
        self.counts = self.counts + at.to(torch.int32)
        self.in_bucket = self.in_bucket + _live(gate)

    def update(self, *args: Any, **kwargs: Any) -> None:
        _, cursor = self._advance(None)
        new_bucket = self._inner.pure_update(self._bucket_at(cursor), *args, **kwargs)
        self._apply_bucket(cursor, new_bucket, None)

    def _masked_update(self, sample_mask: Tensor, *args: Any, **kwargs: Any) -> None:
        # a fully padded lane must neither advance the cursor nor count an update
        gate = sample_mask.any()
        _, cursor = self._advance(gate)
        new_bucket = self._inner._masked_pure_update(self._bucket_at(cursor), sample_mask, *args, **kwargs)
        self._apply_bucket(cursor, new_bucket, gate)

    # -------------------------------------------------------------- compute
    def _cached_fold(self) -> State:
        """The oracle fold's last step from the prefix cache: one
        ``pure_merge`` of the frozen-bucket prefix with the live bucket."""
        c = self.counts.index_select(0, self.cursor.reshape(1))[0]
        nonempty = c > 0
        seen_new = self.pfx_seen + nonempty.to(torch.int32)
        pfx = {k: getattr(self, f"pfx_{k}") for k in self._inner_names}
        merged = self._inner.pure_merge(pfx, self._bucket_at(self.cursor), count=seen_new.clamp(min=1).to(torch.float32))
        return {k: torch.where(nonempty, merged[k], pfx[k]) for k in self._inner_names}

    def compute(self) -> Any:
        valid = (self.pfx_token >= 0) & (self.pfx_token == self.advances)
        if not _is_traced():
            # eager: an invalid cache (a merge poisoned the token) heals in place with one refold
            if not bool(valid):
                self._install_prefix(*self._prefix_fold())
            state = self._cached_fold()
        else:
            n = self.num_buckets
            full, _ = self._fold_positions((self.cursor + 1 + self._positions()) % n)
            cached = self._cached_fold()
            state = {k: torch.where(valid, cached[k], full[k]) for k in self._inner_names}
        return self._inner.pure_compute(state)


class FoldTreeWindow(SlidingWindow):
    """A :class:`SlidingWindow` that also answers sub-range reads in
    ``O(log n)`` merges.

    A host-side sparse table of folds over the ring: level ``k`` holds the
    fold of every ``2^k``-bucket run, each node one inner ``pure_merge`` of
    two level ``k-1`` nodes. :meth:`compute_range` decomposes a range of
    logical buckets greedily into at most ``ceil(log2(n))`` power-of-two spans
    and merges one node per span; ``range_merge_count`` records how many
    merges the last read made. Re-bracketing is exact for integer states and
    within float tolerance for float sums; the running-mean merge is not
    associative, so mean-reduced inner metrics are refused.

    The table is built at the first range read after any change of the state
    (a tick, a reset, a load: anything that moves ``state_version``; and a
    masked tick), reading the cursor and the counts in one transfer.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SumMetric
        >>> from metrics_tpu_torch.streaming import FoldTreeWindow
        >>> w = FoldTreeWindow(SumMetric(device="cpu"), window=4, jit_update=False)
        >>> for v in (1.0, 2.0, 4.0, 8.0):
        ...     w.update(torch.tensor(v))
        >>> float(w.compute_range(1, 3))  # buckets 1..2, oldest first
        6.0
    """

    def __init__(
        self,
        metric: Metric,
        *,
        window: int,
        slide: int = 1,
        shard_state: Any = None,
        jit_update: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            metric, window=window, slide=slide, shard_state=shard_state, jit_update=jit_update, **kwargs
        )
        for name, red in metric._reductions.items():
            if red is dim_zero_mean:
                raise MetricsUserError(
                    f"FoldTreeWindow cannot wrap {type(metric).__name__}: state "
                    f"{name!r} uses the running-mean reduction, which is not "
                    "associative — a fold tree would change its value. Use "
                    "SlidingWindow (full-window reads only) instead."
                )
        # the sparse table: _tree[k][i] = (state, seen) folding logical buckets [i, i + 2^k), for _tree_version
        self._tree: Optional[List] = None
        self._tree_version = -1
        self.range_merge_count = 0
        self.tree_builds = 0

    def _masked_update(self, sample_mask: Tensor, *args: Any, **kwargs: Any) -> None:
        # called directly (the serving layer's padded lanes), it moves no state version
        self._tree = None
        super()._masked_update(sample_mask, *args, **kwargs)

    def _node_combine(self, a: Tuple[State, int], b: Tuple[State, int]) -> Tuple[State, int]:
        """Combine two fold nodes; an empty node passes the other through
        untouched, as the oracle fold skips empty buckets."""
        sa, na = a
        sb, nb = b
        if nb == 0:
            return a
        if na == 0:
            return b
        return self._inner.pure_merge(sa, sb, count=float(na + nb)), na + nb

    def _ensure_tree(self) -> None:
        # an engine's replay runs no Python, so the state version (moved by every update) says when to rebuild
        if self._tree is not None and self._tree_version == self._version:
            return
        n = self.num_buckets
        host = torch.cat([self.cursor.reshape(1), self.counts]).tolist()  # the one host read
        cursor, counts = host[0], host[1:]
        order = [(cursor + 1 + i) % n for i in range(n)]
        level0 = [
            ({k: getattr(self, f"ring_{k}")[p] for k in self._inner_names}, int(counts[p] > 0)) for p in order
        ]
        tree = [level0]
        size = 1
        while size * 2 <= n:
            prev = tree[-1]
            tree.append([self._node_combine(prev[i], prev[i + size]) for i in range(n - size * 2 + 1)])
            size *= 2
        self._tree, self._tree_version = tree, self._version
        self.tree_builds += 1

    def compute_range(self, lo: int, hi: Optional[int] = None) -> Any:
        """The inner value over logical buckets ``[lo, hi)`` (0 = the oldest
        bucket held, ``num_buckets - 1`` = the cursor's; ``hi`` defaults to
        the ring size): at most ``ceil(log2(n))`` merges, counted in
        ``range_merge_count``."""
        if _is_traced():
            raise MetricsUserError("compute_range is a host-side (eager) read; call it outside jit")
        n = self.num_buckets
        hi = n if hi is None else int(hi)
        lo = int(lo)
        if not 0 <= lo < hi <= n:
            raise MetricsUserError(f"compute_range wants 0 <= lo < hi <= {n}, got ({lo}, {hi})")
        self._ensure_tree()
        assert self._tree is not None
        acc: Tuple[State, int] = (self._fresh(), 0)
        merges = 0
        p = lo
        while p < hi:
            k = min((hi - p).bit_length() - 1, len(self._tree) - 1)
            node = self._tree[k][p]
            if node[1] > 0:
                acc = self._node_combine(acc, node)
                merges += 1
            p += 1 << k
        self.range_merge_count = merges
        return self._inner.pure_compute(acc[0])


class ResolutionLadder(_StreamingWindow):
    """Cascading rings at widening resolutions: minute, hour, day.

    Level 0 is a ring of ``levels[0]`` per-tick buckets; each time it wraps,
    its whole ring folds (oldest first) into one bucket of level 1, and so on
    up the ladder: ``sum(levels)`` buckets of state instead of
    ``prod(levels)``. Eagerly a cascade runs only when due (a host read of
    the tick); traced, every tick computes each level's cascade and selects
    it where due (``L`` merges a level a tick). A fully masked tick advances
    nothing and cascades nothing.

    ``compute()`` folds every level coarsest first (chronological), giving
    the value over the whole retained horizon; :meth:`compute_level` reads one
    level alone (level 0: the current minute so far; level 1: the completed
    minutes of this hour, ...).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SumMetric
        >>> from metrics_tpu_torch.streaming import ResolutionLadder
        >>> m = ResolutionLadder(SumMetric(device="cpu"), levels=(2, 2), jit_update=False)
        >>> for v in (1.0, 2.0, 4.0, 8.0, 16.0):
        ...     m.update(torch.tensor(v))
        >>> float(m.compute())  # the whole retained horizon
        31.0
    """

    def __init__(
        self,
        metric: Metric,
        *,
        levels: Tuple[int, ...] = (60, 60, 24),
        jit_update: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(metric, jit_update=jit_update, **kwargs)
        _check_inner(metric, "ResolutionLadder")
        levels = tuple(int(x) for x in levels)
        if not levels or any(x < 2 for x in levels):
            raise MetricsUserError(f"levels must be ring sizes >= 2 (finest first), got {levels}")
        self.levels = levels
        self.n_levels = len(levels)
        # _strides[l]: ticks a level-l bucket holds (1, L0, L0 * L1, ...)
        strides = [1]
        for size in levels[:-1]:
            strides.append(strides[-1] * size)
        self._strides = tuple(strides)
        for lvl, size in enumerate(levels):
            for k, d in self._inner_defaults.items():
                self.add_state(
                    f"lvl{lvl}_{k}", d[None].expand((size,) + tuple(d.shape)), dist_reduce_fx=metric._reductions[k]
                )
            self.add_state(f"lvl{lvl}_counts", torch.zeros((size,), dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("ticks", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="max")

    # ------------------------------------------------------------- cascade
    def _level_leaves(self, lvl: int) -> Tuple[State, Tensor]:
        return {k: getattr(self, f"lvl{lvl}_{k}") for k in self._inner_names}, getattr(self, f"lvl{lvl}_counts")

    def _install_level(self, lvl: int, buckets: State, counts: Tensor) -> None:
        for k in self._inner_names:
            setattr(self, f"lvl{lvl}_{k}", buckets[k])
        setattr(self, f"lvl{lvl}_counts", counts)

    def _fold_level_chrono(self, lvl: int, carry: Tuple[State, Tensor], t: Tensor) -> Tuple[State, Tensor]:
        """Continue a fold across level ``lvl``'s ring oldest first: the next
        write position is the oldest bucket (a cleared bucket counts 0 and is
        skipped)."""
        size = self.levels[lvl]
        cursor = (t // self._strides[lvl]) % size
        order = (cursor + torch.arange(size, dtype=torch.int32, device=self.device)) % size
        buckets, counts = self._level_leaves(lvl)
        return self._fold(carry, {k: buckets[k].index_select(0, order) for k in self._inner_names},
                          counts.index_select(0, order))

    def _cascade_leaves(self, lvl: int, t: Tensor) -> Tuple[State, Tensor, State, Tensor]:
        """Level ``lvl - 1``'s full ring folded into one level-``lvl`` bucket,
        the child cleared: (child buckets, child counts, parent buckets,
        parent counts)."""
        child, ccounts = self._level_leaves(lvl - 1)
        # a just-wrapped child ring was filled 0..L-1 in tick order: index order is chronological
        acc, _ = self._fold((self._fresh(), self._zero_seen()), child, ccounts)
        size = self.levels[lvl]
        at = torch.arange(size, dtype=torch.int32, device=self.device) == ((t // self._strides[lvl]) - 1) % size
        parent, pcounts = self._level_leaves(lvl)
        parent = {k: torch.where(_rows(at, parent[k]), acc[k], parent[k]) for k in self._inner_names}
        pcounts = torch.where(at, ccounts.sum(dtype=torch.int32), pcounts)
        cleared = {k: self._inner_defaults[k][None].expand_as(child[k]).clone() for k in self._inner_names}
        return cleared, torch.zeros_like(ccounts), parent, pcounts

    def _maybe_cascade(self, t: Tensor, gate: Optional[Tensor]) -> None:
        """Run every due cascade. A fully masked tick advances nothing, so it
        must not cascade either: a rerun at the same ``t`` would fold the
        just-cleared child over the parent."""
        if not _is_traced():
            now = int(t)  # the eager path's host read
            if (gate is not None and not bool(gate)) or now <= 0:
                return
            for lvl in range(1, self.n_levels):
                if now % self._strides[lvl] == 0:
                    child, ccounts, parent, pcounts = self._cascade_leaves(lvl, t)
                    self._install_level(lvl - 1, child, ccounts)
                    self._install_level(lvl, parent, pcounts)
            return
        for lvl in range(1, self.n_levels):
            fire = (t > 0) & (t % self._strides[lvl] == 0)
            if gate is not None:
                fire = fire & gate
            child, ccounts, parent, pcounts = self._cascade_leaves(lvl, t)
            old_child, old_ccounts = self._level_leaves(lvl - 1)
            old_parent, old_pcounts = self._level_leaves(lvl)
            self._install_level(lvl - 1, {k: torch.where(fire, child[k], old_child[k]) for k in self._inner_names},
                                torch.where(fire, ccounts, old_ccounts))
            self._install_level(lvl, {k: torch.where(fire, parent[k], old_parent[k]) for k in self._inner_names},
                                torch.where(fire, pcounts, old_pcounts))

    # ---------------------------------------------------------------- tick
    def _tick(self, gate: Optional[Tensor], new_bucket_fn: Any) -> None:
        t = self.ticks
        self._maybe_cascade(t, gate)
        p = t % self.levels[0]
        buckets, counts = self._level_leaves(0)
        new_bucket = new_bucket_fn({k: buckets[k].index_select(0, p.reshape(1))[0] for k in self._inner_names})
        at = torch.arange(self.levels[0], dtype=torch.int32, device=self.device) == p
        if gate is not None:
            at = at & gate
        self._install_level(0, {k: torch.where(_rows(at, buckets[k]), new_bucket[k], buckets[k])
                                for k in self._inner_names}, counts + at.to(torch.int32))
        self.ticks = t + _live(gate)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._tick(None, lambda bucket: self._inner.pure_update(bucket, *args, **kwargs))

    def _masked_update(self, sample_mask: Tensor, *args: Any, **kwargs: Any) -> None:
        self._tick(
            sample_mask.any(),
            lambda bucket: self._inner._masked_pure_update(bucket, sample_mask, *args, **kwargs),
        )

    # ------------------------------------------------------------- compute
    def compute_level(self, level: int) -> Any:
        """The inner value over level ``level``'s ring alone (0 = finest)."""
        if not 0 <= level < self.n_levels:
            raise MetricsUserError(f"level must be in [0, {self.n_levels}), got {level}")
        acc, _ = self._fold_level_chrono(level, (self._fresh(), self._zero_seen()), self.ticks)
        return self._inner.pure_compute(acc)

    def compute(self) -> Any:
        """The inner value over the whole retained horizon: one left fold
        across every level's ring, coarsest level first (chronological)."""
        carry = (self._fresh(), self._zero_seen())
        for lvl in reversed(range(self.n_levels)):
            carry = self._fold_level_chrono(lvl, carry, self.ticks)
        return self._inner.pure_compute(carry[0])


class TumblingWindow(_StreamingWindow):
    """Evaluate ``metric`` over non-overlapping windows of ``window`` updates.

    A *current* accumulator and the snapshot of the last *completed* window;
    when the current window fills, a select moves it into the snapshot and
    re-arms the accumulator. ``compute()`` evaluates the last completed
    window (or the partial current one before any has completed).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SumMetric
        >>> from metrics_tpu_torch.streaming import TumblingWindow
        >>> w = TumblingWindow(SumMetric(device="cpu"), window=2, jit_update=False)
        >>> for v in (1.0, 2.0, 4.0):
        ...     w.update(torch.tensor(v))
        >>> float(w.compute())  # the last completed window: 1 + 2
        3.0
    """

    def __init__(self, metric: Metric, *, window: int, jit_update: bool = True, **kwargs: Any) -> None:
        super().__init__(metric, jit_update=jit_update, **kwargs)
        _check_inner(metric, "TumblingWindow")
        window = int(window)
        if window <= 0:
            raise MetricsUserError(f"window must be positive, got {window}")
        self.window = window
        for k, d in self._inner_defaults.items():
            red = metric._reductions[k]
            self.add_state(f"cur_{k}", d, dist_reduce_fx=red)
            self.add_state(f"done_{k}", d, dist_reduce_fx=red)
        self.add_state("cur_count", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="max")
        self.add_state("done_count", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="max")

    def _step(self, new_cur: State, gate: Optional[Tensor]) -> None:
        cnt = self.cur_count + _live(gate)
        full = cnt >= self.window
        if gate is not None:
            full = full & gate
        for k in self._inner_names:
            cur = new_cur[k] if gate is None else torch.where(gate, new_cur[k], getattr(self, f"cur_{k}"))
            setattr(self, f"done_{k}", torch.where(full, cur, getattr(self, f"done_{k}")))
            setattr(self, f"cur_{k}", torch.where(full, self._inner_defaults[k], cur))
        self.done_count = torch.where(full, cnt, self.done_count)
        self.cur_count = cnt.masked_fill(full, 0)

    def update(self, *args: Any, **kwargs: Any) -> None:
        cur = {k: getattr(self, f"cur_{k}") for k in self._inner_names}
        self._step(self._inner.pure_update(cur, *args, **kwargs), None)

    def _masked_update(self, sample_mask: Tensor, *args: Any, **kwargs: Any) -> None:
        cur = {k: getattr(self, f"cur_{k}") for k in self._inner_names}
        self._step(self._inner._masked_pure_update(cur, sample_mask, *args, **kwargs), sample_mask.any())

    def compute(self) -> Any:
        use_done = self.done_count > 0
        state = {
            k: torch.where(use_done, getattr(self, f"done_{k}"), getattr(self, f"cur_{k}"))
            for k in self._inner_names
        }
        return self._inner.pure_compute(state)


class ExponentialDecay(_StreamingWindow):
    """Exponentially weighted ``metric``: O(1) state, a smooth horizon.

    Before each update every state is multiplied by the float32 ``decay =
    0.5 ** (1 / halflife)``, so a contribution ``halflife`` updates old
    carries half the weight of a fresh one. Needs sum or mean reductions
    (max and min are refused). Integer states are held as float32, so the
    inner update adds its integer counts into float states (int32 + float32
    gives float32, as in the JAX package).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanMetric
        >>> from metrics_tpu_torch.streaming import ExponentialDecay
        >>> m = ExponentialDecay(MeanMetric(device="cpu"), halflife=10.0, jit_update=False)
        >>> for v in (1.0, 2.0, 3.0):
        ...     m.update(torch.tensor(v))
        >>> round(float(m.compute()), 3)  # recent updates weigh more
        2.046
    """

    _device_attributes = ("_decay_factor",)

    def __init__(self, metric: Metric, *, halflife: float, jit_update: bool = True, **kwargs: Any) -> None:
        super().__init__(metric, jit_update=jit_update, **kwargs)
        _check_inner(metric, "ExponentialDecay", allow_max_min=False)
        halflife = float(halflife)
        if not halflife > 0:
            raise MetricsUserError(f"halflife must be positive, got {halflife}")
        self.halflife = halflife
        self.decay = float(0.5 ** (1.0 / halflife))
        self._decay_factor = torch.tensor(self.decay, dtype=torch.float32, device=self.device)
        self._inner_defaults = {
            k: d if d.is_floating_point() else d.to(torch.float32) for k, d in self._inner_defaults.items()
        }
        for k, d in self._inner_defaults.items():
            self.add_state(f"ew_{k}", d, dist_reduce_fx=metric._reductions[k])

    def _decayed(self, gate: Optional[Tensor]) -> State:
        out = {}
        for k in self._inner_names:
            ew = getattr(self, f"ew_{k}")
            out[k] = self._decay_factor * ew if gate is None else torch.where(gate, self._decay_factor * ew, ew)
        return out

    def _apply(self, new_state: State, gate: Optional[Tensor]) -> None:
        for k in self._inner_names:
            ew = getattr(self, f"ew_{k}")
            setattr(self, f"ew_{k}", new_state[k] if gate is None else torch.where(gate, new_state[k], ew))

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._apply(self._inner.pure_update(self._decayed(None), *args, **kwargs), None)

    def _masked_update(self, sample_mask: Tensor, *args: Any, **kwargs: Any) -> None:
        gate = sample_mask.any()
        self._apply(self._inner._masked_pure_update(self._decayed(gate), sample_mask, *args, **kwargs), gate)

    def compute(self) -> Any:
        return self._inner.pure_compute({k: getattr(self, f"ew_{k}") for k in self._inner_names})
