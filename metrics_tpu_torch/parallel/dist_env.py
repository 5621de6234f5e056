"""The collectives under ``Metric.sync``: port of ``metrics_tpu/parallel/dist_env.py``.

One small abstraction, :class:`DistEnv`, serves every regime:

* :class:`NoOpEnv`: one process, world size 1 (``torch.distributed`` not
  initialised, or a world of one).
* :class:`ProcessEnv`: the processes of a ``torch.distributed`` process
  group, the default group unless one is given. Shapes that differ between
  ranks are gathered as the JAX package gathers them: sizes exchanged,
  padded to the largest, gathered, trimmed.

The JAX package's ``AxisEnv`` (collectives over a named mesh axis inside a
``shard_map`` trace) has no counterpart: PyTorch has no SPMD trace, every
rank runs its own program and meets the others in eager collectives. The
mapping:

* a mesh-axis name (``process_group="dp"``, ``pure_sync(state, "dp")``)
  becomes a process group (``process_group=group``,
  ``pure_sync(state, group)``; ``None`` is the default group);
* a collective over a sub-mesh becomes one over a group made with
  ``torch.distributed.new_group``;
* ``psum``/``pmax``/``pmin`` become ``all_reduce`` with ``SUM``/``MAX``/
  ``MIN``, ``psum_scatter`` becomes ``reduce_scatter_tensor``, and
  ``all_to_all`` becomes ``all_to_all_single``.

A ``mean`` is reduced as the JAX package's ``ProcessEnv`` reduces it, one
gather and a mean over the ranks, never ``ReduceOp.AVG``: not every backend
has it, and it sums in another order.

Every collective runs under :func:`metrics_tpu_torch.resilience.run_collective`:
an attempt that fails before it reaches the backend is tried again; one
that fails inside it (past the group's own timeout, a peer gone) degrades to
local-only state, and the group is issued no further collective (see there).
"""
from typing import Callable, List, Optional

import torch
import torch.distributed as dist
from torch import Tensor

from metrics_tpu_torch.resilience import run_collective

class DistEnv:
    """The collectives a sync uses. ``shard_group`` is the process group
    whose ``shard_state=`` leaves this env shards (the JAX package's
    ``axis_name``); None where it shards none."""

    shard_group = None

    def world_size(self) -> int:
        raise NotImplementedError

    def all_gather(self, x: Tensor) -> List[Tensor]:
        """``x`` from every participant, as a list of per-rank tensors."""
        raise NotImplementedError

    def all_gather_uniform(self, x: Tensor) -> List[Tensor]:
        """:meth:`all_gather` of a tensor whose shape is the same on every
        rank, so the env may skip the size exchange. Default: ``all_gather``."""
        return self.all_gather(x)

    def all_reduce(self, x: Tensor, op: str) -> Optional[Tensor]:
        """The reduction over participants (``op`` in sum, mean, max, min),
        or None where the env has no better path than gather and reduce."""
        return None

    def is_distributed(self) -> bool:
        return self.world_size() > 1


class NoOpEnv(DistEnv):
    """One participant: a gather gives the input back."""

    def world_size(self) -> int:
        return 1

    def all_gather(self, x: Tensor) -> List[Tensor]:
        return [x]


def _wire(x: Tensor) -> Tensor:
    """Bools cross as uint8 (not every backend reduces or gathers bool)."""
    return x.to(torch.uint8) if x.dtype == torch.bool else x


def _unwire(x: Tensor, dtype: torch.dtype) -> Tensor:
    return x.to(torch.bool) if dtype == torch.bool else x


class ProcessEnv(DistEnv):
    """The ranks of a ``torch.distributed`` process group (the default
    group where ``group`` is None).

    With ``shards`` (the env of ``pure_sync(state, group)``) the leaves
    declared ``shard_state=`` over ``group`` sync sharded: each rank keeps its
    own rows. Every backend gets the same calls on the data's own device:
    the tensor forms (``all_gather_into_tensor``, ``reduce_scatter_tensor``,
    ``all_to_all_single``) and ``all_reduce`` with ``SUM``/``MAX``/``MIN``;
    on CUDA tensors gloo stages through the host inside the call. A call's
    deadline is the group's own timeout; see
    :func:`~metrics_tpu_torch.resilience.run_collective` for what a failure
    does.
    """

    def __init__(self, group: Optional["dist.ProcessGroup"] = None, shards: bool = False) -> None:
        self.group = group
        # the stateful sync never shards (as the JAX package's ProcessEnv); pure_sync's env does
        self.shard_group = (dist.group.WORLD if group is None else group) if shards else None
        self._world = dist.get_world_size(group)

    def world_size(self) -> int:
        return self._world

    def _run(self, attempt: Callable[[], object], fallback: Callable[[], object], desc: str):
        return run_collective(attempt, fallback, "ProcessEnv", desc, group=self.group)

    def _gather_into(self, x: Tensor) -> Tensor:
        """One gather of equal shapes (at least 1-d): ``(world, *x.shape)``.
        The output is the ranks' tensors concatenated on dim 0, the layout
        every backend takes (gloo refuses a stacked one)."""
        out = torch.empty((self._world * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous(), group=self.group)
        return out.view(self._world, *x.shape)

    def all_gather(self, x: Tensor) -> List[Tensor]:
        x = torch.atleast_1d(x)
        dtype, wx = x.dtype, _wire(x)

        def attempt() -> List[Tensor]:
            # sizes exchanged, padded to the largest, gathered, trimmed (metrics_tpu/parallel/dist_env.py:147-160)
            local = torch.tensor([wx.shape[0]], dtype=torch.int64, device=wx.device)
            sizes = self._gather_into(local).reshape(-1).tolist()
            top = max(sizes)
            if top == 0:
                return [_unwire(wx, dtype)] * self._world  # every rank empty: nothing to gather
            padded = wx
            if wx.shape[0] != top:
                padded = torch.cat([wx, wx.new_zeros((top - wx.shape[0], *wx.shape[1:]))])
            gathered = self._gather_into(padded)
            return [_unwire(gathered[i, : sizes[i]], dtype) for i in range(self._world)]

        # local-only degradation: world-size-1 semantics for this leaf
        return self._run(attempt, lambda: [x], "all_gather")

    def all_gather_uniform(self, x: Tensor) -> List[Tensor]:
        """One gather, no size exchange: fixed-shape states have the same
        shape on every rank."""
        x = torch.atleast_1d(x)
        dtype, wx = x.dtype, _wire(x)

        def attempt() -> List[Tensor]:
            gathered = self._gather_into(wx)
            return [_unwire(gathered[i], dtype) for i in range(self._world)]

        return self._run(attempt, lambda: [x], "all_gather_uniform")

    def all_reduce(self, x: Tensor, op: str) -> Optional[Tensor]:
        """``sum``, ``max`` and ``min`` as one native ``all_reduce``; ``mean``
        as one gather and a mean over the ranks (integers and bools give a
        float32 mean, as ``jnp.mean`` does). A bool sum counts in int32, as
        ``jnp.sum`` does."""
        if op not in ("sum", "mean", "max", "min"):
            return None
        x = torch.atleast_1d(x)

        if op == "mean":
            def attempt() -> Tensor:
                stacked = self._gather_into(_wire(x))
                return _float_mean(stacked)

            return self._run(attempt, lambda: _float_mean(x[None]), "all_reduce[mean]")

        wire = x.to(torch.int32) if x.dtype == torch.bool else x
        native = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]

        def attempt() -> Tensor:
            y = wire.clone()
            dist.all_reduce(y, op=native, group=self.group)
            return y if op == "sum" else _unwire(y, x.dtype)

        return self._run(attempt, lambda: wire if op == "sum" else x, f"all_reduce[{op}]")

    def reduce_scatter(self, x: Tensor) -> Tensor:
        """``(world, M)`` in, this rank's row summed over the ranks out: the
        JAX package's ``psum_scatter`` of a shard-major buffer. Sum only."""
        world, m = x.shape

        def attempt() -> Tensor:
            out = torch.empty((m,), dtype=x.dtype, device=x.device)
            dist.reduce_scatter_tensor(out, x.contiguous().reshape(-1), group=self.group)
            return out

        return self._run(attempt, lambda: x[dist.get_rank(self.group)], "reduce_scatter")

    def all_to_all(self, x: Tensor) -> Tensor:
        """``(world, W)`` in, ``(world, W)`` out: row ``r`` of the result is
        the row rank ``r`` sent to this rank (the JAX package's
        ``all_to_all`` with split and concat on axis 0); the caller reduces
        over dim 0."""

        def attempt() -> Tensor:
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x.contiguous(), group=self.group)
            return out

        # local-only degradation: this rank's own row alone, a world of one
        return self._run(attempt, lambda: x[dist.get_rank(self.group)][None], "all_to_all")


def _float_mean(stacked: Tensor) -> Tensor:
    return torch.mean(stacked if stacked.is_floating_point() else stacked.to(torch.float32), dim=0)


def default_env() -> DistEnv:
    """A :class:`ProcessEnv` over the default group where ``torch.distributed``
    is initialised with more than one rank, else a :class:`NoOpEnv`."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return ProcessEnv()
    return NoOpEnv()


def group_env(group: Optional["dist.ProcessGroup"] = None) -> DistEnv:
    """The env of ``pure_sync(state, group)`` and ``assemble_sharded``: a
    sharding :class:`ProcessEnv` over ``group`` (None: the default group),
    or a :class:`NoOpEnv` where ``torch.distributed`` is not initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        return NoOpEnv()
    return ProcessEnv(group, shards=True)
