"""One run of one cell: find the cell's files by name, set up, measure the window, check, report.

Data is found under a root directory (the checkout): ``BENCHMARK.json``, the configuration file it
names, ``portbench/mixes/<traffic>.json`` and ``portbench/limits/<workload>.json``. Code is found in
this package by name: ``portbench/tasks/<task>.py`` (the configuration's ``task``) and
``portbench/layers/<metric>.py`` (one reader a per-layer metric). A new cell, mix, configuration or
per-layer metric is a new file and a new entry, never an edit here.
"""
import contextlib
import gc
import importlib
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

# never loaded in the process that reports: the JAX reference package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "metrics_tpu")
MIB = 2**20


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, mix and limits read."""

    def __init__(self, root: Path, manifest: Dict, workload: Dict) -> None:
        self.root, self.manifest, self.workload = root, manifest, workload
        self.name = workload["name"]
        entry = next(c for c in manifest["configs"] if c["name"] == workload["config"])
        self.config = json.loads((root / entry["file"]).read_text())
        self.mix = json.loads((root / "portbench" / "mixes" / f"{workload['traffic']}.json").read_text())
        limits_file = root / "portbench" / "limits" / f"{self.name}.json"
        self.limits = json.loads(limits_file.read_text())["limits"] if limits_file.exists() else None

    def metrics(self, section: str) -> List[Dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
        return [m for m in self.manifest[section] if self.name in m.get("workloads", [self.name])]


def load_manifest(root: Path) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cells(root: Path) -> Dict[str, Cell]:
    manifest = load_manifest(root)
    return {w["name"]: Cell(root, manifest, w) for w in manifest["workloads"]}


def task_class(config: Dict) -> Any:
    return importlib.import_module(f"portbench.tasks.{config['task']}").Task


def layer_reader(name: str) -> Any:
    """The ``read`` function of ``portbench/layers/<name>.py``."""
    return importlib.import_module(f"portbench.layers.{name}").read


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reserved(device: torch.device) -> int:
    return torch.cuda.memory_reserved(device) if device.type == "cuda" else 0


def check(cell: Cell, task: Any, control: bool = False) -> Dict[str, Any]:
    """The compared numbers over every epoch, each beside its limit, and how many epochs broke one."""
    per_epoch = task.readings(control=control)
    limits = cell.limits or {}
    failed = sum(any(r[k] > limits.get(k, float("-inf")) for k in r) for r in per_epoch)
    numbers = {k: {"value": max(r[k] for r in per_epoch), "limit": limits.get(k)} for k in per_epoch[0]}
    correct = cell.limits is not None and failed == 0
    return {"correct": correct, "attempted": len(per_epoch), "failed": failed, "numbers": numbers}


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool, device: torch.device, t0: float,
        log=lambda msg: print(msg, file=sys.stderr, flush=True)) -> Dict[str, Any]:
    """One run; returns the result line as a dict. ``t0`` is the process's start on ``time.time()``."""
    cell = cells(root)[workload]
    cuda = device.type == "cuda"
    marks = [("python_and_torch", time.time() - t0)]
    if cuda:
        torch.cuda.init()
    base = _reserved(device)
    marks.append(("cuda_context", time.time() - t0))
    task = task_class(cell.config)(cell.config, cell.mix, seed, device)
    if cuda:
        torch.cuda.empty_cache()
    inputs_reserved = _reserved(device) - base
    marks.append(("inputs", time.time() - t0))
    task.build()
    marks.append(("build", time.time() - t0))
    task.warm()
    _synchronize(device)
    marks.append(("warm", time.time() - t0))
    log(json.dumps({"setup_s_at": dict(marks)}))
    setup_peak = torch.cuda.max_memory_reserved(device) if cuda else 0
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    retraces = task.retraces()

    session = contextlib.nullcontext()
    if trace:
        from metrics_tpu_torch import telemetry

        session = telemetry.instrument()
    images = 0
    with session as spans:
        setup_s = time.time() - t0
        start = time.perf_counter()
        while True:
            images += task.epoch(time_compute=trace)
            if time.perf_counter() - start >= seconds:
                break
        _synchronize(device)
        window_s = time.perf_counter() - start
    epochs = len(task.epochs)
    window_peak = torch.cuda.max_memory_reserved(device) if cuda else 0
    window_alloc_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    retraces = task.retraces() - retraces
    log(json.dumps({"window": {"seconds": window_s, "epochs": epochs, "images": images, "retraces": retraces,
                               "setup_peak_reserved": setup_peak, "peak_reserved": window_peak,
                               "peak_allocated": window_alloc_peak, "inputs_reserved": inputs_reserved,
                               "inputs_bytes": task.input_bytes}}))

    e2e = {"images_per_s": images / window_s, "metric_peak_mib": (window_peak - base - inputs_reserved) / MIB,
           "setup_s": setup_s}
    device_info: Dict[str, Any] = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": cell.workload["chips"],
        "memory_peak_bytes": int(max(setup_peak, window_peak)),
    }
    breakdown: Dict[str, Any] = {}
    if trace:
        from portbench import trace as tracing

        kinds: Dict[str, int] = {}
        for e in spans.spans(name="update"):
            kinds[e.kind] = kinds.get(e.kind, 0) + 1
        log(json.dumps({"update_spans": kinds, "window_retraces": retraces}))
        reading = tracing.Reading(compute_ms=list(task.compute_ms), work=task.update_work())
        if cuda:
            tracing.profile(task, device, reading, epoch_s=window_s / epochs)
            log(json.dumps({"device_trace": {"epochs": reading.epochs, "updates": reading.updates,
                                             "ops": len(reading.ops), "launches": reading.launches()}}))
            device_info["busy_s"] = reading.busy_us() / 1e6
            device_info["window_s"] = reading.window_us() / 1e6
            breakdown["breakdown"] = reading.breakdown()
        metrics = {}
        for m in cell.metrics("per_layer"):
            value = layer_reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in cell.metrics("end_to_end")}

    task.free_program()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    verdict = check(cell, task)
    return {"correct": verdict["correct"], "attempted": verdict["attempted"], "failed": verdict["failed"],
            "metrics": metrics, "device": device_info, **breakdown, "checks": verdict["numbers"]}
