"""Engine: device ms an update of the copies that stage each batch into the captured graphs' static
inputs, the profiler's ``Memcpy`` activities, over the traced epochs' updates."""


def read(reading):
    if not reading.ops or not reading.updates:
        return None
    return reading.device_us(reading.is_copy) / 1e3 / reading.updates
