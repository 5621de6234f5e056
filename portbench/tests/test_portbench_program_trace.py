"""The readers of what the program traces itself, on hand-made readings: the engine's stage ranges, its
rows counters, and the device phase marks in its captured graphs; and what each gives where the program
has none of them (a checkout from before they were added)."""
import pytest

from portbench import harness
from portbench.trace import Reading

WORK = [{"rows": 1000, "input_bytes": 3.35e6, "num_classes": 20}]


def _reading(ops=(), host=(), updates=1):
    reading = Reading(compute_ms=[], work=WORK * updates)
    reading.ops, reading.host, reading.window, reading.epochs = list(ops), list(host), (0.0, 1000.0), 1
    return reading


def _mark(phase, start):
    return (f"void (anonymous namespace)::phase_mark_{phase}()", start, start + 2.0)


# two updates of a two-member program: format, count, format, count, writeback, end
REPLAY = [("format", 0.0), ("count", 30.0), ("format", 40.0), ("count", 90.0), ("writeback", 100.0), ("end", 105.0)]
OPS = [_mark(p, t) for p, t in REPLAY] + [_mark(p, t + 200.0) for p, t in REPLAY] + [
    ("void at::native::reduce_kernel<512, 1>(...)", 5.0, 25.0),
    ("void (anonymous namespace)::confmat_split(int const*, int const*, int*, long)", 33.0, 37.0),
    ("Memcpy HtoD (Pageable -> Device)", 150.0, 190.0),  # staging, between two replays: in no phase
]


@pytest.mark.parametrize("name, value", [
    # from each mark's end to the next mark's start, summed over both members, over two updates
    ("format_marked_ms", 2 * ((30.0 - 2.0) + (90.0 - 42.0)) / 1e3 / 2),
    ("count_marked_ms", 2 * ((40.0 - 32.0) + (100.0 - 92.0)) / 1e3 / 2),
])
def test_phase_readers_time_each_phase_from_its_mark_to_the_next(name, value):
    assert harness.layer_reader(name)(_reading(ops=OPS, updates=2)) == pytest.approx(value)


@pytest.mark.parametrize("name", ["format_marked_ms", "count_marked_ms"])
def test_phase_readers_give_nothing_without_marks(name):
    unmarked = [op for op in OPS if "phase_mark_" not in op[0]]
    assert harness.layer_reader(name)(_reading(ops=unmarked, updates=2)) is None
    assert harness.layer_reader(name)(_reading(ops=OPS, updates=0)) is None


def test_engine_host_us_sums_the_engine_stages_but_the_launch():
    host = [
        ("portbench.update", 0.0, 100.0),
        ("metrics_tpu.MetricCollection.update[fused-aot]", 1.0, 99.0),
        ("metrics_tpu.MetricCollection.update.prepare", 1.0, 11.0),
        ("metrics_tpu.MetricCollection.update.stage", 11.0, 16.0),
        ("metrics_tpu.MetricCollection.update.launch", 16.0, 90.0),  # the host waits on the card: left out
        ("cudaGraphLaunch", 17.0, 89.0),
        ("metrics_tpu.MetricCollection.update.install", 90.0, 99.0),
        ("metrics_tpu.MetricCollection.update.prepare", 110.0, 114.0),
        ("metrics_tpu.MetricCollection.update.stage", 114.0, 115.0),
        ("metrics_tpu.MetricCollection.update.launch", 115.0, 120.0),
        ("metrics_tpu.MetricCollection.update.install", 120.0, 121.0),
        ("metrics_tpu.JaccardIndex.compute", 130.0, 140.0),
    ]
    read = harness.layer_reader("engine_host_us")
    assert read(_reading(host=host)) == pytest.approx(((10 + 5 + 9) + (4 + 1 + 1)) / 2)
    assert read(_reading(host=[h for h in host if not h[0].endswith((".prepare", ".stage", ".launch", ".install"))])) is None


def test_engine_useful_rows_pct_reads_the_program_counters(monkeypatch):
    from metrics_tpu_torch import telemetry

    read = harness.layer_reader("engine_useful_rows_pct")
    monkeypatch.setattr(telemetry, "snapshot", lambda: {"update:fused-aot": 3, "update:rows": 12, "update:bucket_rows": 16})
    assert read(_reading()) == pytest.approx(75.0)
    monkeypatch.setattr(telemetry, "snapshot", lambda: {"update:fused-aot": 3})  # a program without the counters
    assert read(_reading()) is None
