"""The port's cost model, billing and hazards held against the JAX package on the CPU.

The pure functions (``classify``, ``launch_attrs``, ``compile_attrs``,
``apportion``, ``cost_microusd``, ``hazards.predicted``) get the JAX
package's own cases (``tests/bases/test_cost_model.py``,
``tests/bases/test_billing.py``) and the same inputs through both packages:
outputs must be equal, integer microdollars and shares exactly, float
attributes to rtol 1e-6. The device tables share their rows with the JAX
package's. An engine program's entry is the sum of the kernel terms its
capture recorded plus its I/O bytes; on the CPU, where there is no graph,
the I/O bytes alone.
"""
import json
import os

import numpy as np
import pytest
import torch

import metrics_tpu_torch
from metrics_tpu.analysis import billing as jax_billing
from metrics_tpu.analysis import cost_model as jax_cost_model
from metrics_tpu.analysis import hazards as jax_hazards
from metrics_tpu_torch import analysis, telemetry
from metrics_tpu_torch.analysis import billing, cost_model, hazards
from metrics_tpu_torch.ops import registry

C = 4


def _entries(rng, n=50):
    """The same entries in both packages' ``CostEntry``."""
    out = []
    for i in range(n):
        flops, nbytes = float(rng.choice([0.0, 1.0, 1e3, 1e6, 1e9]) * rng.rand()), float(rng.randint(0, 10**7))
        fields = dict(owner=f"X{i}", family="update", key_id=f"{i:012x}", flops=flops, bytes_accessed=nbytes,
                      peak_temp_bytes=float(rng.randint(0, 100)), arg_bytes=1.0, out_bytes=2.0)
        out.append((cost_model.CostEntry(**fields), jax_cost_model.CostEntry(**fields)))
    return out


def _close(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], float):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
        else:
            assert a[k] == b[k], k


def test_classify_and_launch_attrs_math_as_in_jax():
    assert cost_model.classify(0.5, ridge=1.0) == "bandwidth-bound"
    assert cost_model.classify(2.0, ridge=1.0) == "compute-bound"
    entry = cost_model.CostEntry(owner="X", family="update", key_id="abc", flops=1e6, bytes_accessed=1e6,
                                 peak_temp_bytes=0, arg_bytes=0, out_bytes=0)
    assert entry.intensity == 1.0
    a = cost_model.launch_attrs(entry, 1000.0)  # 1 ms: 1 GFLOP/s and 1 GB/s
    assert a["achieved_gflops"] == pytest.approx(1.0) and a["achieved_gbps"] == pytest.approx(1.0)
    assert a["model_flops"] == 1e6
    assert cost_model.launch_attrs(None, 1000.0) == {} and cost_model.compile_attrs(None) == {}
    assert "achieved_gflops" not in cost_model.launch_attrs(entry, None)


@pytest.mark.parametrize("dur_us", [None, 0.0, 3.5, 1000.0])
def test_launch_and_compile_attrs_equal_jax(dur_us):
    assert cost_model.device_peaks() is None and jax_cost_model.device_peaks() is None  # the CPU: relative basis
    for port_entry, jax_entry in _entries(np.random.RandomState(0)):
        _close(cost_model.launch_attrs(port_entry, dur_us), jax_cost_model.launch_attrs(jax_entry, dur_us))
        assert cost_model.compile_attrs(port_entry) == jax_cost_model.compile_attrs(jax_entry)
    for intensity in (0.0, 1.0, 99.9, 100.0, 1e4):
        assert cost_model.classify(intensity) == jax_cost_model.classify(intensity)


def test_device_tables_keep_the_jax_rows_they_share():
    assert cost_model.NOMINAL_RIDGE == jax_cost_model.NOMINAL_RIDGE
    assert set(cost_model.DEVICE_PEAKS) == {"H100", "cuda"}
    for key, row in cost_model.DEVICE_PEAKS.items():
        assert row == jax_cost_model.DEVICE_PEAKS[key]
        gflops, gbps = row
        assert 10.0 < gflops / gbps < 1000.0
    assert cost_model.DEVICE_PEAKS["H100"] == (67000.0, 3350.0)  # PERF.md's bound: 67 TFLOP/s, 3.35 TB/s
    assert set(billing.DEVICE_RATES) == {"H100", "cuda", "cpu"}
    for key, rate in billing.DEVICE_RATES.items():
        assert rate == jax_billing.DEVICE_RATES[key]
    assert billing.CPU_HOST_PEAKS == jax_billing.CPU_HOST_PEAKS


def test_record_static_keys_and_registry_as_in_jax():
    cost_model.reset()
    e = cost_model.record_static("ops.stat_scores", "kernel", (1024, 1000, "int32"), flops=3.0, bytes_accessed=5.0)
    j = jax_cost_model.record_static("ops.stat_scores", "kernel", (1024, 1000, "int32"), flops=3.0, bytes_accessed=5.0)
    # the port's entry ends with one field more, its program's device phase marks: none for a static entry
    assert tuple(e)[:len(j)] == tuple(j) and e.marks == ()
    assert cost_model.lookup(e.key_id) is e and cost_model.entries() == {e.key_id: e}
    cost_model.reset()
    assert cost_model.entries() == {}


def test_apportion_sums_exactly_and_equals_jax():
    rng = np.random.RandomState(0)
    for _ in range(200):
        n = int(rng.randint(1, 12))
        total = int(rng.randint(0, 10_000))
        weights = [int(w) for w in rng.randint(0, 50, n)]
        shares = billing.apportion(total, weights)
        assert shares == jax_billing.apportion(total, weights)
        assert len(shares) == n and all(s >= 0 for s in shares) and sum(shares) == total
    for total, weights, want in ((10, [1, 1], [5, 5]), (10, [3, 1], [8, 2]), (1, [1, 1, 1], [1, 0, 0]),
                                 (2, [1, 1, 1], [1, 1, 0]), (5, [0, 5], [0, 5]), (4, [0, 0], [2, 2]),
                                 (0, [7, 9], [0, 0]), (3, [], [])):
        assert billing.apportion(total, weights) == jax_billing.apportion(total, weights) == want


def test_cost_microusd_and_modeled_seconds_equal_jax():
    billing.reset()
    jax_billing.reset()

    class _Entry:
        flops = 100.0
        bytes_accessed = 64.0

    assert billing.modeled_device_seconds(_Entry()) > 0
    assert billing.cost_microusd(_Entry()) == jax_billing.cost_microusd(_Entry()) == 1
    assert billing.cost_microusd(None) == 0
    for port_entry, jax_entry in _entries(np.random.RandomState(1)):
        assert billing.cost_microusd(port_entry) == jax_billing.cost_microusd(jax_entry)
        np.testing.assert_allclose(billing.modeled_device_seconds(port_entry),
                                   jax_billing.modeled_device_seconds(jax_entry), rtol=1e-6)
        _close(billing.launch_cost_attrs(port_entry), jax_billing.launch_cost_attrs(jax_entry))


def test_device_rate_resolves_on_the_cpu_host_as_in_jax():
    billing.reset()
    jax_billing.reset()
    assert billing.device_rate() == jax_billing.device_rate() == ("cpu", 0.20)
    assert billing.rate_snapshot() == jax_billing.rate_snapshot() == {"rate_key": "cpu", "usd_per_hour": 0.20,
                                                                      "enabled": True}


def test_billing_kill_switch(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_BILLING", "0")
    entry = cost_model.CostEntry("X", "update", "k", 1e6, 1e6, 0.0, 0.0, 0.0)
    assert not billing.billing_enabled() and billing.launch_cost_attrs(entry) == {}
    assert billing.rate_snapshot()["enabled"] is False


@pytest.mark.parametrize("owner", ["Accuracy", "MetricCollection", "NoSuchMetric"])
@pytest.mark.parametrize("cause", ["new-static-key", "new-signature", "new-input-signature", "first-compile",
                                   "new-shape-bucket", "new-dtype"])
def test_hazards_predicted_equals_jax_on_the_checked_in_baseline(owner, cause):
    """Each package reads its own checked-in baseline (the port's
    ``STATIC_AUDIT_TORCH.json``, the JAX package's ``STATIC_AUDIT.json``), and
    both predict the same for these owners."""
    hazards.invalidate()
    jax_hazards.invalidate()
    assert os.path.basename(hazards.baseline_path()) == "STATIC_AUDIT_TORCH.json"
    assert os.path.basename(jax_hazards.baseline_path()) == "STATIC_AUDIT.json"
    assert hazards.predicted(owner, cause) == jax_hazards.predicted(owner, cause)
    assert hazards.predicted(owner, cause) in ((False,) if cause in hazards.CAUSE_TO_HAZARD else (None,))


def test_hazards_read_an_overriding_baseline_as_jax_does(monkeypatch, tmp_path):
    path = tmp_path / "audit.json"
    path.write_text(json.dumps({"hazards": {"FlagSum": {"static-key": True, "signature": False}}}))
    monkeypatch.setenv("METRICS_TPU_STATIC_AUDIT", str(path))
    hazards.invalidate()
    jax_hazards.invalidate()
    try:
        for cause in ("new-static-key", "new-signature", "first-compile"):
            assert hazards.predicted("FlagSum", cause) == jax_hazards.predicted("FlagSum", cause)
        assert hazards.predicted("FlagSum", "new-static-key") is True
    finally:
        hazards.invalidate()
        jax_hazards.invalidate()


def test_analysis_names_its_submodules_and_refuses_the_rest():
    """The static audit is ported (``program_audit`` is ``jaxpr_audit``'s
    counterpart); any other name raises."""
    assert sorted(analysis.__all__) == ["ast_lint", "billing", "cost_model", "hazards", "program_audit", "registry",
                                        "report"]
    assert analysis.cost_model is cost_model
    with pytest.raises(AttributeError, match="counterpart is 'program_audit'"):
        analysis.jaxpr_audit
    with pytest.raises(AttributeError, match="no attribute 'nothing'"):
        analysis.nothing


# ------------------------------------------------------------------ the engine's entry
class _Program:
    def __init__(self, launched, arg_bytes, out_bytes, peak_temp_bytes=0):
        self.launched, self.arg_bytes, self.out_bytes = launched, arg_bytes, out_bytes
        self.peak_temp_bytes = peak_temp_bytes


def test_a_program_entry_is_its_recorded_kernels_plus_its_io_bytes():
    # a capture writes each launch down with its terms (and counts nothing, fires no event)
    with telemetry.instrument() as session, registry.recording() as launched:
        registry.note_launch("stat_scores", "block", (1024, 1000), cost_key=(1024, 1000, "int32"),
                             flops=3072.0, bytes_accessed=25312.0)
        registry.note_launch("confusion_matrix", "band", (1024, 1000), cost_key=(1024, 1000),
                             flops=1024.0, bytes_accessed=4008192.0)
    assert session.events == [] and launched == [("stat_scores", "block", (1024, 1000), 3072.0, 25312.0),
                                                  ("confusion_matrix", "band", (1024, 1000), 1024.0, 4008192.0)]
    entry = cost_model.record("MetricCollection", "update", ("k",), _Program(launched, 4100.0, 12000.0, 512))
    assert entry.flops == 3072.0 + 1024.0
    assert entry.bytes_accessed == 25312.0 + 4008192.0 + 4100.0 + 12000.0
    assert (entry.arg_bytes, entry.out_bytes, entry.peak_temp_bytes) == (4100.0, 12000.0, 512.0)
    assert cost_model.record("X", "update", ("k",), object()) is None


def test_a_launch_outside_a_capture_records_its_kernel_entry_and_event():
    registry.reset_stats()
    before = registry.launches()["countmin"]
    with telemetry.instrument() as session:
        for _ in range(2):
            registry.note_launch("countmin", "shared", (4096, 4, 1024), cost_key=(4096, 4, 1024),
                                 flops=11.0 * 4096 * 4, bytes_accessed=8.0 * 4096 + 16 + 8.0 * 4096)
    assert registry.launches()["countmin"] == before + 2
    first, second = session.spans(name="kernel")
    assert (first.owner, first.kind) == ("ops.countmin_scatter", "kernel")  # the JAX package's name
    assert first.attrs["first"] is True and second.attrs["first"] is False
    entry = cost_model.lookup(first.attrs["cost_key"])
    assert (entry.owner, entry.family, entry.flops) == ("ops.countmin_scatter", "kernel", 11.0 * 4096 * 4)
    assert first.attrs["model_bytes"] == entry.bytes_accessed and first.attrs["roofline_basis"] == "relative"
    assert registry.engaged("ops.countmin_scatter") == {"ops.countmin_scatter": {"countmin_scatter"}}
    registry.reset_launches()


def test_the_engine_entry_on_the_cpu_is_its_io_bytes():
    rng = np.random.RandomState(3)
    m = metrics_tpu_torch.Accuracy(num_classes=C, average="macro", jit_update=True, device="cpu")
    with telemetry.instrument() as session:
        for rows in (8, 13):
            m.update(torch.from_numpy(rng.rand(rows, C).astype(np.float32)),
                     torch.from_numpy(rng.randint(0, C, rows).astype(np.int32)))
    state_bytes = sum(v.numel() * v.element_size() for v in m.state().values())
    compiles = session.spans(name="compile")
    assert [e.attrs["cause"] for e in compiles] == ["first-compile", "new-shape-bucket"]
    for span, bucket in zip(compiles, (8, 16)):
        entry = cost_model.lookup(span.attrs["cost_key"])
        inputs = bucket * C * 4 + bucket * 4  # the padded (B, C) float32 scores and (B,) int32 labels
        assert (entry.flops, entry.arg_bytes, entry.out_bytes) == (0.0, inputs + state_bytes, state_bytes)
        assert entry.bytes_accessed == span.attrs["cost_bytes"] == inputs + 2 * state_bytes
    for span in session.spans(name="update"):
        assert span.attrs["cost_key"] in {e.attrs["cost_key"] for e in compiles}
        assert span.attrs["model_bytes"] > 0 and span.attrs["achieved_gbps"] >= 0


def test_unsubscribed_launches_build_no_cost_attrs():
    assert not telemetry.subscribed()
    with telemetry.instrument():
        assert telemetry.subscribed()
    assert not telemetry.subscribed()


def test_the_kill_switch_leaves_a_launch_counted_and_nothing_else(monkeypatch):
    """With ``METRICS_TPU_TELEMETRY=0`` a launch is counted, and records no cost entry, no event and no
    engagement: the switch takes away the whole per-launch cost of the telemetry."""
    monkeypatch.setenv("METRICS_TPU_TELEMETRY", "0")
    registry.reset_stats()
    cost_model.reset()
    telemetry.reset_counters()
    before = registry.launches()["countmin"]
    with registry.lowering("Sketch"):
        registry.note_launch("countmin", "shared", (64, 2, 64), cost_key=(64, 2, 64), flops=1.0, bytes_accessed=2.0)
    assert registry.launches()["countmin"] == before + 1
    assert cost_model.entries() == {} and registry.engaged() == {} and telemetry.snapshot() == {}
    registry.reset_launches()
