"""Device: the share of the traced epochs' window in which no device operation ran, from the union
of the profiler's device intervals."""


def read(reading):
    window_us = reading.window_us()
    if window_us <= 0 or not reading.ops:
        return None
    return 100.0 * (1.0 - reading.busy_us() / window_us)
