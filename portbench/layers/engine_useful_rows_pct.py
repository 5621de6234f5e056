"""Engine: the share of the rows the engine's programs ran that were the user's, from the program's
always-on counters (``metrics_tpu_torch.telemetry.snapshot()``): 100 x ``update:rows`` (each engine
update's true batch length) over ``update:bucket_rows`` (the rows its program ran: a masked program's
padded bucket). The counters hold the whole run, warm-up and traced epochs included. A program
without these counters gives nothing."""


def read(reading):
    from metrics_tpu_torch import telemetry

    counters = telemetry.snapshot()
    bucket = counters.get("update:bucket_rows")
    if not bucket:
        return None
    return 100.0 * counters.get("update:rows", 0) / bucket
