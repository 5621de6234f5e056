"""``tools/torch_trace_report.py``: the JAX package's trace summary over the
port's telemetry export, with no JAX. One port export goes through both
tools and gives the same summary text."""
import runpy
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _tool(name):
    return runpy.run_path(str(REPO / "tools" / name), run_name="tool")


@pytest.fixture(scope="module")
def bench_export(tmp_path_factory):
    """The tool's --bench run on the CPU: ten fused-collection forwards and a compute."""
    path = str(tmp_path_factory.mktemp("trace") / "trace.jsonl")
    _tool("torch_trace_report.py")["run_instrumented_bench"](path, "cpu")
    return path


def test_one_port_export_gives_the_same_summary_in_both_tools(bench_export, monkeypatch):
    from metrics_tpu.ops import registry as jax_registry

    # a kernel engaged by earlier JAX tests in this process would change the JAX tool's kernel column
    monkeypatch.setattr(jax_registry, "_engaged_by_owner", {})
    ours, theirs = _tool("torch_trace_report.py"), _tool("trace_report.py")
    events = ours["load_events"](bench_export)
    assert events == theirs["load_events"](bench_export)
    summary = ours["summarize"](events)
    assert summary == theirs["summarize"](events)
    forwards = [e for e in events if e["name"] == "forward"]
    assert len(forwards) == 10 and {e["kind"] for e in forwards} == {"fused-aot"}
    assert "roofline" in summary and "MetricCollection:fused-aot" in summary
    # batch 128 builds the 128-row bucket's program, 129..137 the 256-row bucket's
    assert "retraces: 2" in summary.splitlines()
    assert [e["attrs"]["cause"] for e in events if e["name"] == "compile"] == ["first-compile", "new-shape-bucket"]


def test_the_kernel_column_reads_the_ports_spec_table():
    from metrics_tpu_torch import ops

    assert ops.kernel_status("ops.stat_scores") == ops.kernel_status("X", "kernel") == "yes"
    assert ops.kernel_status("Accuracy") == ops.kernel_status("BinnedAveragePrecision") == "eligible"
    assert ops.kernel_status("SlidingWindow") == "eligible" and ops.kernel_status("MeanSquaredError") == "no"
    assert ops.names() == ["binned_stats", "confusion_matrix", "countmin", "retrieval_sort", "stat_scores",
                           "window_tick"]
    assert {s.kind for s in ops.specs()} == {"cuda", "fused-graph"} and ops.registry.get("countmin").covers == (
        "CountMin",)


def test_the_cli_summarizes_an_export(bench_export, capsys):
    assert _tool("torch_trace_report.py")["main"]([bench_export]) == 0
    out = capsys.readouterr().out
    assert out.startswith("events: ") and "cold start -> first result" in out
