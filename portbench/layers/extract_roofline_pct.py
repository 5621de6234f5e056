"""Network: the InceptionV3 trunk's share of its roofline. The least time is its operations on the
traced epochs' images at the float32 peak (``portbench.inception_flops``); the time is the device
time the program marks as the trunk's: from each ``extract`` phase mark's end to the next mark's start
in the captured graphs. A program without marks gives nothing."""
from portbench import inception_flops
from portbench.layers.format_marked_ms import phase_ms


def read(reading):
    per_update_ms = phase_ms(reading, "extract")
    if not per_update_ms or not any("images" in w for w in reading.work):
        return None
    marked_us = per_update_ms * 1e3 * reading.updates
    return 100.0 * inception_flops.least_seconds(reading.work) * 1e6 / marked_us
