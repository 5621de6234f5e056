"""Fused forward: a ``forward`` step (state advance and batch value) as one program.

Port of ``metrics_tpu/forward_engine.py:1-204``. ``forward`` runs on every
training or logging step; its eager form is five phases (copy the state,
reset, update, compute, merge), two updates where ``full_state_update`` is
set. The engine makes the whole step one program of the
:mod:`metrics_tpu_torch.dispatch` cache (on the card one CUDA graph a static
key, shape bucket and dtype), which takes the state leaves and the batch
and returns the new leaves and the batch value. Two program shapes, as the
eager branches:

* ``full_state_update=False``: one update, on a default state; the batch
  value is ``pure_compute`` of that batch state, and ``pure_merge`` folds it
  into the state, with the update count carried as a device scalar so that a
  growing count builds nothing new.
* ``full_state_update=True`` (or ``None``): two updates, one on the state
  and one on a default state, whose value is the batch value.

The engine serves metrics built with ``jit_update=True`` whose states are
all tensors; any failure restores the state and degrades the call to the
eager branches through :mod:`metrics_tpu_torch.resilience`. The batch value
of a replay lies in the graph's memory, which the next replay overwrites, so
:meth:`~metrics_tpu_torch.dispatch.FastDispatcher.forward` returns a copy.
``METRICS_TPU_FUSED_FORWARD=0`` turns the engine off: ``Metric.forward``
takes the eager branches and ``MetricCollection.forward`` its eager loop.
"""
import os
from typing import Any, Callable, Dict, Tuple

import torch

from metrics_tpu_torch.utilities.data import _squeeze_if_scalar


def fused_forward_enabled() -> bool:
    """Kill switch (env ``METRICS_TPU_FUSED_FORWARD``, default on)."""
    return os.environ.get("METRICS_TPU_FUSED_FORWARD", "1").lower() not in ("0", "false", "off")


def padded_mask(args: Tuple, dyn: Dict, n_valid: torch.Tensor) -> torch.Tensor:
    """The dim-0 validity mask of a padded (shape-bucketed) batch."""
    first = next(x for x in (*args, *dyn.values()) if isinstance(x, torch.Tensor) and x.ndim >= 1)
    return torch.arange(first.shape[0], dtype=torch.int32, device=first.device) < n_valid


def make_metric_forward_factories(metric: Any, names: list) -> Tuple[Callable, Callable]:
    """The forward programs of one ``Metric``: each factory closes over the
    static kwargs and returns ``fn(count, [n_valid,] leaves, *args, **dyn)
    -> (new_leaves, batch_value)``."""
    full_state = bool(metric.full_state_update) or metric.full_state_update is None

    def _program(update_fn: Callable, static: Dict) -> Callable:
        def fn(count, leaves, *args, **dyn):
            state = dict(zip(names, leaves))
            batch_state = update_fn(metric.default_state(), *args, **dyn, **static)
            if full_state:
                new_state = update_fn(state, *args, **dyn, **static)
            else:
                new_state = metric.pure_merge(state, batch_state, count=count)
            batch_val = _squeeze_if_scalar(metric.pure_compute(batch_state))
            return tuple(new_state[k] for k in names), batch_val

        return fn

    def make_forward(static: Dict) -> Callable:
        return _program(metric.pure_update, static)

    def make_masked_forward(static: Dict) -> Callable:
        def fn(count, n_valid, leaves, *args, **dyn):
            mask = padded_mask(args, dyn, n_valid)

            def masked_update(state, *a, **kw):
                return metric._masked_pure_update(state, mask, *a, **kw)

            return _program(masked_update, static)(count, leaves, *args, **dyn)

        return fn

    return make_forward, make_masked_forward


def _member_pure_update(m: Any, state: Dict, *args: Any, **kwargs: Any) -> Dict:
    return m.pure_update(state, *args, **kwargs)


def make_collection_forward_factories(
    collection: Any, unflatten: Callable, flatten: Callable
) -> Tuple[Callable, Callable]:
    """The forward programs of a ``MetricCollection``: the whole collection
    advances and gives its batch values in one program, its
    ``_fused_forward_impl``. ``counts`` is a ``{name: count}`` dict."""

    def make_forward(static: Dict) -> Callable:
        def fn(counts, leaves, *args, **kwargs):
            new_states, batch_vals = collection._fused_forward_impl(
                _member_pure_update, unflatten(leaves), counts, *args, **kwargs
            )
            return flatten(new_states), batch_vals

        return fn

    def make_masked_forward(static: Dict) -> Callable:
        def fn(counts, n_valid, leaves, *args, **kwargs):
            mask = padded_mask(args, kwargs, n_valid)

            def masked_update(m, state, *a, **kw):
                return m._masked_pure_update(state, mask, *a, **kw)

            new_states, batch_vals = collection._fused_forward_impl(
                masked_update, unflatten(leaves), counts, *args, **kwargs
            )
            return flatten(new_states), batch_vals

        return fn

    return make_forward, make_masked_forward


def metric_forward(metric: Any, args: Tuple, kwargs: Dict) -> Any:
    """One ``Metric.forward`` step through the engine; returns the batch
    value. The dispatcher installs the new leaves; this mirrors the eager
    path's bookkeeping (update count, memo). An exception is the caller's
    cue to restore its snapshot and serve the call eagerly."""
    args, static, dynamic, key = metric._split_update_args(args, kwargs)
    if metric._dispatcher is None:
        metric._dispatcher = metric._make_dispatcher()
    # the merge count is a device scalar: step N+1 replays step N's graph
    batch_val = metric._dispatcher.forward(float(metric._update_count + 1), static, key, args, dynamic)
    metric._update_count += 1
    metric._computed = None
    metric._bump_version()
    return batch_val
