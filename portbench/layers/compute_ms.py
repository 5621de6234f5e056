"""Module compute: host ms of each epoch's ``compute()`` until its values reach the host, the device
drained before it (in the traced run only), the mean over the window's epochs."""


def read(reading):
    return sum(reading.compute_ms) / len(reading.compute_ms) if reading.compute_ms else None
