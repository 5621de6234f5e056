"""Input formatting: device ms an update of every kernel that is neither one of the program's
registry kernels (``portbench/kernels.json``) nor a copy or a fill, over the traced epochs' updates."""


def read(reading):
    if not reading.ops or not reading.updates:
        return None

    def formatting(name):
        return not (reading.is_copy(name) or reading.is_memset(name) or reading.kernel_of(name))

    return reading.device_us(formatting) / 1e3 / reading.updates
