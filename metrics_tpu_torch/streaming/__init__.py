"""Sketch aggregators: fixed-shape streaming state (port of ``metrics_tpu/streaming``).

The windowed wrappers of ``metrics_tpu/streaming/window.py`` are not ported
yet (ROADMAP.md, Queue A item 9).
"""
from metrics_tpu_torch.streaming.sketch import (  # noqa: F401
    CountMinHeavyHitters,
    HostQuantileSketch,
    HyperLogLog,
    QuantileSketch,
)

__all__ = ["CountMinHeavyHitters", "HostQuantileSketch", "HyperLogLog", "QuantileSketch"]
