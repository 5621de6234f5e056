"""Streaming metrics: windowed wrappers and fixed-shape sketch aggregators
(port of ``metrics_tpu/streaming``)."""
from metrics_tpu_torch.streaming.sketch import (  # noqa: F401
    CountMinHeavyHitters,
    HostQuantileSketch,
    HyperLogLog,
    QuantileSketch,
)
from metrics_tpu_torch.streaming.window import (  # noqa: F401
    ExponentialDecay,
    FoldTreeWindow,
    ResolutionLadder,
    SlidingWindow,
    TumblingWindow,
)

__all__ = [
    "CountMinHeavyHitters",
    "ExponentialDecay",
    "FoldTreeWindow",
    "HostQuantileSketch",
    "HyperLogLog",
    "QuantileSketch",
    "ResolutionLadder",
    "SlidingWindow",
    "TumblingWindow",
]
