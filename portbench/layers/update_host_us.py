"""Engine: host µs of one update outside the CUDA runtime, over the traced epochs: each
``collection.update`` call (the harness's ``portbench.update`` range) less the time inside it in CUDA
API calls (``cuda*``, ``cu*``), where the host waits on a full command buffer while the card is the
bottleneck. What is left is the host work of the collection's fused update and the engine's dispatch
(flattening, the program's key, staging), as the profiler, which adds its own cost to each op, sees it."""


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def read(reading):
    updates = [(a, b) for name, a, b in reading.host if name == "portbench.update"]
    if not updates:
        return None
    calls = sorted((a, b) for name, a, b in reading.host if reading.is_runtime(name))
    own = 0.0
    for a, b in updates:
        own += (b - a) - _union_us([(max(c, a), min(d, b)) for c, d in calls if d > a and c < b])
    return own / len(updates)
