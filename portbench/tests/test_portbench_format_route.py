"""The reader of the program's formatting-route counters, and what it gives where the program has none of
them (a checkout from before they were added)."""
import pytest

from portbench import harness
from portbench.trace import Reading


def test_format_label_route_pct_reads_the_program_counters(monkeypatch):
    from metrics_tpu_torch import telemetry

    read = harness.layer_reader("format_label_route_pct")
    reading = Reading(compute_ms=[], work=[])
    monkeypatch.setattr(telemetry, "snapshot", lambda: {"update:fused-aot": 3, "format:labels": 6})
    assert read(reading) == pytest.approx(100.0)
    monkeypatch.setattr(telemetry, "snapshot", lambda: {"format:labels": 3, "format:onehot": 1})
    assert read(reading) == pytest.approx(75.0)
    monkeypatch.setattr(telemetry, "snapshot", lambda: {"update:fused-aot": 3})  # a program without the counters
    assert read(reading) is None


def test_a_cells_collection_reads_100_through_the_engine_on_the_cpu():
    import torch

    import metrics_tpu_torch
    from metrics_tpu_torch import telemetry

    mc = metrics_tpu_torch.MetricCollection(
        [metrics_tpu_torch.JaccardIndex(num_classes=5, ignore_index=4, update_method="matmul", jit_update=True,
                                        device="cpu"),
         metrics_tpu_torch.Accuracy(num_classes=5, ignore_index=4, mdmc_average="global", jit_update=True,
                                    device="cpu")],
        fused_update=True, compute_groups=True)
    telemetry.reset_counters()
    g = torch.Generator().manual_seed(0)
    for _ in range(2):
        mc.update(torch.rand(2, 5, 8, 8, generator=g), torch.randint(0, 5, (2, 8, 8), generator=g))
    assert harness.layer_reader("format_label_route_pct")(Reading(compute_ms=[], work=[])) == pytest.approx(100.0)
