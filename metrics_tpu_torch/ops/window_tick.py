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
"""
from typing import Any, Dict, Tuple


def _tick_engine(window: Any) -> Any:
    """The window's fused-tick engine, built at its first call (a copy of the
    window starts without one): the engine ``jit_update=True`` would give
    it, with its own program cache."""
    if window._fused_tick is None:
        object.__setattr__(window, "_fused_tick", window._make_dispatcher())
    return window._fused_tick


def fused_window_tick(window: Any, args: Tuple, kwargs: Dict) -> bool:
    """Run one tick of ``window`` (``update(*args, **kwargs)``) as a single
    captured program; returns True once the new state is installed.

    The tick counts as an update: the window's update count and state version
    move and its memoised ``compute`` is dropped, as the wrapped ``update``
    that runs the JAX package's op does, and ``window.dispatch_stats``
    counts the tick (``dispatches``) and any program it built (``retraces``).
    """
    call_args, static, dynamic, key = window._split_update_args(tuple(args), dict(kwargs))
    _tick_engine(window).update(static, key, call_args, dynamic)
    window._computed = None
    window._update_count += 1
    window._bump_version()
    return True
