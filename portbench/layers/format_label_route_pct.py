"""Input formatting: the share of the member updates whose classification inputs were formatted
straight to class labels, from the program's always-on counters (``metrics_tpu_torch.telemetry.snapshot()``):
100 x ``format:labels`` over ``format:labels`` + ``format:onehot`` (one a member update; an engine
program's members counted once a call from its ``update`` span). The counters hold the whole run, warm-up
and traced epochs included. A program without these counters gives nothing."""


def read(reading):
    from metrics_tpu_torch import telemetry

    counters = telemetry.snapshot()
    labels, onehot = counters.get("format:labels", 0), counters.get("format:onehot", 0)
    if not labels + onehot:
        return None
    return 100.0 * labels / (labels + onehot)
