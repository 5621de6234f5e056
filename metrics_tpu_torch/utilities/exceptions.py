"""Framework exceptions (copies of ``metrics_tpu/utilities/exceptions.py`` and
``metrics_tpu.resilience.StateCorruptionError``)."""


class MetricsUserError(Exception):
    """Error raised on misuse of the metrics API (double-sync, compute-before-update, ...)."""


class StateCorruptionError(RuntimeError):
    """A checkpoint payload or restored state failed integrity checks."""
