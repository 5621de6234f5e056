"""The traced run's readers on a hand-made trace: what each takes from the host events and device
operations, and what each leaves out."""
import pytest

from portbench import harness
from portbench.trace import Reading

WORK = [{"rows": 1000, "input_bytes": 3.35e6, "num_classes": 20}]


def _reading(ops=(), host=(), window=(0.0, 100.0)):
    reading = Reading(compute_ms=[], work=WORK)
    reading.ops, reading.host, reading.window, reading.epochs = list(ops), list(host), window, 1
    return reading


def test_update_host_us_leaves_out_the_time_in_cuda_calls():
    host = [
        ("portbench.update", 0.0, 40.0),
        ("cudaMemcpyAsync", 5.0, 10.0),
        ("cudaGraphLaunch", 12.0, 30.0),
        ("Command Buffer Full", 14.0, 29.0),  # inside the launch: counted once
        ("aten::copy_", 3.0, 11.0),  # host work: kept
        ("portbench.update", 50.0, 60.0),
        ("cudaGraphLaunch", 58.0, 65.0),  # runs past the update's end: only its part inside counts
        ("cudaLaunchKernel", 70.0, 80.0),  # outside every update
    ]
    read = harness.layer_reader("update_host_us")
    assert read(_reading(host=host)) == pytest.approx(((40 - 5 - 18) + (10 - 2)) / 2)
    assert read(_reading(host=[("cudaGraphLaunch", 0.0, 1.0)])) is None


@pytest.mark.parametrize("name, value", [
    ("engine_copy_ms", 10.0 / 1e3),
    ("format_device_ms", 30.0 / 1e3),
    ("device_idle_pct", 100.0 - 57.0),
    ("confmat_roofline_pct", 100.0 * (2 * 1000 + 4 * 400) / 3.35e12 * 1e6 / 15.0),
    ("update_roofline_pct", 100.0 * 1.0 / 57.0),
])
def test_device_readers_on_a_hand_made_trace(name, value):
    ops = [
        ("Memcpy DtoD (Device -> Device)", 0.0, 10.0),
        ("Memset (Device)", 10.0, 12.0),
        ("void (anonymous namespace)::confmat_split(int const*, int const*, int*, long)", 12.0, 27.0),
        ("void at::native::reduce_kernel<512, 1>(...)", 40.0, 70.0),
    ]
    assert harness.layer_reader(name)(_reading(ops=ops)) == pytest.approx(value)
