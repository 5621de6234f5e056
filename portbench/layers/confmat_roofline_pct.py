"""Kernels: the ``confusion_matrix`` kernel's share of its roofline. The least time is the bytes the
problem needs over the HBM rate: each update's n rows of two labels at one byte each (C <= 256) read
once, and its C x C table of 4-byte counts written once; the time is the traced ``confmat_*`` kernels'."""
from portbench import peaks


def confmat_bytes(rows, num_classes):
    """Bytes one confusion-matrix count must move: two one-byte labels a row, the int32 table once."""
    if num_classes > 256:
        raise ValueError("one-byte labels hold at most 256 classes")
    return 2 * rows + 4 * num_classes * num_classes


def read(reading):
    kernel_us = reading.device_us(lambda name: reading.kernel_of(name) == "confusion_matrix")
    if kernel_us <= 0:
        return None
    least_s = sum(peaks.least_seconds(confmat_bytes(w["rows"], w["num_classes"])) for w in reading.work)
    return 100.0 * least_s * 1e6 / kernel_us
