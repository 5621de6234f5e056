"""Input formatting: the share of the images through the InceptionV3 trunk that the extractor resized
first, from the program's always-on counters (``metrics_tpu_torch.telemetry.snapshot()``): 100 x
``extract:resized`` over ``extract:images`` (an engine program's counted once a call from its
``update`` span). The counters hold the whole run, set-up and traced epochs included. A program
without these counters gives nothing."""


def read(reading):
    from metrics_tpu_torch import telemetry

    counters = telemetry.snapshot()
    images = counters.get("extract:images")
    if not images:
        return None
    return 100.0 * counters.get("extract:resized", 0) / images
