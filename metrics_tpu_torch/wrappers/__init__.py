"""Wrappers around other metrics (port of ``metrics_tpu/wrappers``)."""
from metrics_tpu_torch.wrappers.bootstrapping import BootStrapper  # noqa: F401
from metrics_tpu_torch.wrappers.classwise import ClasswiseWrapper  # noqa: F401
from metrics_tpu_torch.wrappers.minmax import MinMaxMetric  # noqa: F401
from metrics_tpu_torch.wrappers.multioutput import MultioutputWrapper  # noqa: F401
from metrics_tpu_torch.wrappers.tracker import MetricTracker  # noqa: F401

__all__ = ["BootStrapper", "ClasswiseWrapper", "MetricTracker", "MinMaxMetric", "MultioutputWrapper"]
