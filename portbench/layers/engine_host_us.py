"""Engine: host µs of one traced update in the engine's own stages, read from the program's profiler
ranges: the sum of each call's ``metrics_tpu.<owner>.update.prepare``, ``.stage`` and ``.install``
ranges (its checks, snapshot, key and lookup; the copies into the static inputs; the leaves written
back and the bookkeeping), over the traced calls (one ``.update.launch`` range each). The launch stage,
where the host waits on a full command buffer while the card is the bottleneck, is left out. A program
without these ranges gives nothing."""

OWN_STAGES = ("prepare", "stage", "install")


def _stage(name):
    """The stage an engine range names, or None: ``metrics_tpu.<owner>.update.<stage>``."""
    if not name.startswith("metrics_tpu."):
        return None
    head, _, stage = name.rpartition(".")
    return stage if head.endswith(".update") else None


def read(reading):
    calls, own = 0, 0.0
    for name, a, b in reading.host:
        stage = _stage(name)
        if stage == "launch":
            calls += 1
        elif stage in OWN_STAGES:
            own += b - a
    return own / calls if calls else None
