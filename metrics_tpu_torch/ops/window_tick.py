"""Fused ``SlidingWindow`` tick: a whole tick as one CUDA graph replay.

Port of ``metrics_tpu/ops/window_tick.py:53``. An eager sliding-window tick
issues a few dozen small launches: the cursor advance, the bucket clear, the
prefix-cache upkeep, the bucket gather, the inner ``pure_update`` and the
scatter back (``streaming/window.py``). :func:`fused_window_tick` captures the
window's own ``pure_update`` once per window instance and input shape bucket,
on the fast-dispatch engine's capture machinery (the window's own
:meth:`~metrics_tpu_torch.metric.Metric._make_dispatcher`), and replays the
graph on every later tick: one graph launch a tick, beside the copy of the
batch into the graph's inputs.

It is a fused program, not a kernel written by hand: the inner update is
arbitrary user code. So it is not in ``registry.KERNELS``; the registry
kernels its graph holds are written down at the capture and counted on every
replay (``registry.recording``/``note_replay``), as for any engine graph.

The program is the window's own ``pure_update``, run as traced (the refold
and cached read as selects), so its values are those of the eager tick bit
for bit. On the CPU the engine runs that program directly. There is no
fallback: a graph that fails to capture or replay raises.

Telemetry (``metrics_tpu/ops/window_tick.py:47-83``): each tick is one
``update`` span of kind ``window-tick`` (the engine's launch span), and one
``kernel`` event of ``ops.window_tick`` with the JAX package's model terms:
every state leaf read and written once.
"""
from typing import Any, Dict, Tuple

from metrics_tpu_torch.ops import registry

registry.register("window_tick", "fused-graph", ("SlidingWindow",),
                  "one sliding-window tick (gather, update, scatter, advance) as one captured CUDA graph")


def _tick_engine(window: Any) -> Any:
    """The window's fused-tick engine, built at its first call (a copy of the
    window starts without one): the engine ``jit_update=True`` would give
    it, with its own program cache."""
    if window._fused_tick is None:
        engine = window._make_dispatcher()
        engine.kind = "window-tick"
        object.__setattr__(window, "_fused_tick", engine)
    return window._fused_tick


def _model_terms(state: Dict[str, Any]) -> Tuple[float, float]:
    """Analytic cost terms: one tick touches every state leaf once."""
    nbytes = float(sum(v.numel() * v.element_size() for v in state.values()))
    return 2.0 * len(state), 2.0 * nbytes  # leaves read + written


def fused_window_tick(window: Any, args: Tuple, kwargs: Dict) -> bool:
    """Run one tick of ``window`` (``update(*args, **kwargs)``) as a single
    captured program; returns True once the new state is installed.

    The tick counts as an update: the window's update count and state version
    move and its memoised ``compute`` is dropped, as the wrapped ``update``
    that runs the JAX package's op does, and ``window.dispatch_stats``
    counts the tick (``dispatches``) and any program it built (``retraces``).
    """
    call_args, static, dynamic, key = window._split_update_args(tuple(args), dict(kwargs))
    state = {k: getattr(window, k) for k in window._defaults}
    _tick_engine(window).update(static, key, call_args, dynamic)
    window._computed = None
    window._update_count += 1
    window._bump_version()
    flops, nbytes = _model_terms(state)
    registry.record_cost("window_tick", tuple((k, tuple(v.shape)) for k, v in state.items()), flops, nbytes)
    return True
