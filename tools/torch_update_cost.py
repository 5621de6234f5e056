"""The wall time of a warm update of the port, taken from one checkout, so
that two commits can be compared on one card.

    python3 tools/torch_update_cost.py [--root DIR] [--reps N]

Imports ``metrics_tpu_torch`` from ``--root`` (default: this checkout) and
times, up to the device's completion, a warm update at 1,024 rows of 1,000
classes (softmax scores from a seed) of ``Accuracy(1000)`` on its engine
(``jit_update=True``), of ``Accuracy(1000)`` eager, and of ``chip_smoke.py``'s
eleven-member ImageNet collection fused (``fused_update=True``; the members
as this checkout's ``chip_smoke.evaluation_members`` makes them). Each is
timed with the telemetry switch off (``METRICS_TPU_TELEMETRY=0``, set
outside the clock) and on with no session (the default), the two in turns
(``chip_smoke.host_ms_in_turns``, median of ``--reps``), one path after the
other. A checkout that has no telemetry ignores the switch: its two
readings differ by the method's noise alone. Where the checkout has
telemetry, also times its idle parts on the host, per call (median of five
blocks of 10,000 calls): a span (``clock`` and ``emit``), the same with the
timeline off, a read of the switch, and a kernel launch's cost entry and
event. Prints the card's name and power limit and one JSON line. Without a
card it exits 1 and measures nothing.

To compare a parent commit with a change, unpack the parent into a directory
that ``.gitignore`` lists and run, in one call: parent, change, change,
parent (``--root`` the parent's directory, then this checkout).
"""
import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, CLASSES, SEED = 1024, 1000, 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=REPO, help="the checkout whose metrics_tpu_torch is imported")
    parser.add_argument("--reps", type=int, default=200)
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_update_cost: no CUDA device is visible", file=sys.stderr)
        return 1
    import metrics_tpu_torch as M

    if os.path.dirname(os.path.dirname(os.path.abspath(M.__file__))) != root:
        raise RuntimeError(f"imported {M.__file__}, not the package under {root}")
    # this checkout's chip_smoke.py, by its path: the other checkout's is first on sys.path
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)
    preds = torch.softmax(torch.randn(ROWS, CLASSES, generator=g, device=dev), dim=1)
    target = torch.randint(0, CLASSES, (ROWS,), generator=g, device=dev)
    paths = {
        "accuracy_engine": M.Accuracy(num_classes=CLASSES, average="macro", jit_update=True, device=dev),
        "accuracy_eager": M.Accuracy(num_classes=CLASSES, average="macro", device=dev),
        "collection_fused": M.MetricCollection(smoke.evaluation_members(M, dev), prefix="val_", fused_update=True),
    }
    ms = {}
    for path, m in paths.items():
        fns = {how: (lambda m=m: m.update(preds, target)) for how in ("off", "idle")}
        ms[path] = smoke.host_ms_in_turns(torch, fns, reps=args.reps, warmup=5, around={"off": smoke.telemetry_off})
        ms[path]["idle_over_off"] = ms[path]["idle"] / ms[path]["off"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    print(json.dumps({"root": root, "rows": ROWS, "classes": CLASSES, "reps": args.reps, "ms": ms,
                      "idle_parts_us": idle_parts()}))
    return 0


def idle_parts():
    """Host µs a call of each idle part of the telemetry (telemetry on, no session), or None without it."""
    try:
        from metrics_tpu_torch import telemetry
        from metrics_tpu_torch.ops import registry
    except ImportError:
        return None

    def span():
        telemetry.emit("update", "Accuracy", "aot", t0=telemetry.clock())

    def per_call(fn, calls=10_000, blocks=5):
        times = []
        for _ in range(blocks):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) * 1e6 / calls)
        return statistics.median(times)

    assert not telemetry.subscribed()
    parts = {"span": per_call(span), "switch_read": per_call(telemetry.telemetry_enabled),
             "kernel_cost_entry_and_event": per_call(
                 lambda: registry.record_cost("stat_scores", (ROWS, CLASSES), 3.0 * ROWS, 13.0 * ROWS + 12.0 * CLASSES))}
    os.environ["METRICS_TPU_TIMELINE"] = "0"
    try:
        parts["span_timeline_off"] = per_call(span)
    finally:
        os.environ.pop("METRICS_TPU_TIMELINE")
    return parts


if __name__ == "__main__":
    sys.exit(main())
