"""Model: the whole step's share of the card's float32 peak over the traced epochs: the trunk's
operations on every generated image the traced epochs updated (``portbench.inception_flops``: two a
multiply-add of its convolutions at the extractor's input size), over the traced window (resets,
updates, computes and the gaps between them) at 67 TFLOP/s."""
from portbench import inception_flops


def read(reading):
    window_us = reading.window_us()
    if window_us <= 0 or not any("images" in w for w in reading.work):
        return None
    return 100.0 * inception_flops.least_seconds(reading.work) * 1e6 / window_us
