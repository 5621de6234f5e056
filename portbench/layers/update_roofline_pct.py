"""Device: the whole update's share of its roofline. The least time is the bytes of the user's batch
(scores or labels, and the target, as the mix hands them) read once over the HBM rate; the time is the
device's busy time in the traced epochs. Whatever implements the update, the work is the same."""
from portbench import peaks


def update_bytes(work):
    return work["input_bytes"]


def read(reading):
    busy_us = reading.busy_us()
    if busy_us <= 0:
        return None
    least_s = sum(peaks.least_seconds(update_bytes(w)) for w in reading.work)
    return 100.0 * least_s * 1e6 / busy_us
