"""The traced run's readings: a device trace of a few whole epochs after the window, reduced to device
operations, busy time, host events, idle gaps and their host causes.

``torch.profiler`` keeps only the device activities that fall inside its own window, and has been
seen to lose some late in a long process; so a short capture is taken right after the window, padded
on both sides, after a warm-up step whose events are dropped. A capture is whole when it holds every
launch of the program's registry kernels that ``metrics_tpu_torch.ops.registry`` counted in it; one
that is not whole is taken again, and where none is, the traced run fails rather than read low.
"""
import contextlib
import json
import math
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

PACKAGE = Path(__file__).resolve().parent
PAD_S = 0.05
PROFILE_S = 2.0  # seconds of device trace, rounded up to whole epochs
TRIES = 3


def kernel_table() -> Dict[str, Tuple[str, ...]]:
    table = json.loads((PACKAGE / "kernels.json").read_text())["kernels"]
    return {name: tuple(prefixes) for name, prefixes in table.items()}


class Reading:
    """What the per-layer readers read. Times are µs on the profiler's clock."""

    def __init__(self, compute_ms: List[float], work: List[Dict[str, float]]) -> None:
        self.compute_ms = compute_ms  # the window's computes, host ms each
        self.epoch_work = work  # the problem of each update of one epoch
        self.ops: List[Tuple[str, float, float]] = []  # device operations in the traced epochs
        self.host: List[Tuple[str, float, float]] = []  # host events in the traced epochs
        self.window: Optional[Tuple[float, float]] = None
        self.epochs = 0
        self.kernels = kernel_table()

    # ---------------------------------------------------------------- reductions
    @property
    def work(self) -> List[Dict[str, float]]:
        return self.epoch_work * self.epochs

    @property
    def updates(self) -> int:
        return len(self.epoch_work) * self.epochs

    def window_us(self) -> float:
        return self.window[1] - self.window[0] if self.window else 0.0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for _, a, b in sorted(self.ops, key=lambda op: op[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    @staticmethod
    def is_copy(name: str) -> bool:
        return name.startswith("Memcpy")

    @staticmethod
    def is_memset(name: str) -> bool:
        return name.startswith("Memset")

    def kernel_of(self, name: str) -> Optional[str]:
        """The registry kernel a device operation belongs to, or None. The profiler gives a kernel's
        demangled signature, its namespace in front (``(anonymous namespace)::confmat_split(int const*, ...)``)."""
        bare = name.replace("(anonymous namespace)::", "")
        bare = bare[5:] if bare.startswith("void ") else bare
        symbol = bare.split("(", 1)[0].split("<", 1)[0].rsplit("::", 1)[-1]
        for kernel, prefixes in self.kernels.items():
            if symbol.startswith(prefixes):
                return kernel
        return None

    @staticmethod
    def is_runtime(name: str) -> bool:
        """A CUDA API call on the host (``cudaGraphLaunch``, ``cuLaunchKernel``), or the
        profiler's mark of a launch held back by a full command buffer: where the host waits on the card."""
        return name.startswith("cu") or name == "Command Buffer Full"

    def launches(self) -> Dict[str, int]:
        """Traced launches of each registry kernel."""
        out: Dict[str, int] = {}
        for name, _, _ in self.ops:
            kernel = self.kernel_of(name)
            if kernel:
                out[kernel] = out.get(kernel, 0) + 1
        return out

    def device_us(self, which) -> float:
        return sum(b - a for name, a, b in self.ops if which(name))

    def breakdown(self) -> Dict[str, List[List[Any]]]:
        by_name: Dict[str, float] = {}
        for name, a, b in self.ops:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[name[:160], us / 1e6] for name, us in top],
                "idle_gaps": [[cause[:160], us / 1e6] for cause, us in self.idle_gaps()[:10]]}

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Idle time of the traced window by what the host was doing at each gap's middle: the innermost
        annotated range and the innermost host event there, summed by that pair, longest first."""
        if not self.window:
            return []
        edges, last = [], self.window[0]
        for a, b in self.busy_intervals() + [(self.window[1], self.window[1])]:
            if a > last:
                edges.append((last, a))
            last = max(last, b)
        host = sorted(self.host, key=lambda e: e[1])
        active: List[Tuple[str, float, float]] = []  # host events begun by the gap's middle, a sweep
        nxt = 0
        by_cause: Dict[str, float] = {}
        for a, b in edges:
            mid = (a + b) / 2
            while nxt < len(host) and host[nxt][1] <= mid:
                active.append(host[nxt])
                nxt += 1
            active = [e for e in active if e[2] >= mid]
            ranges = [e for e in active if e[0].startswith(("portbench.", "metrics_tpu."))]
            inner = min(active, key=lambda e: e[2] - e[1])[0] if active else "host outside any traced event"
            outer = min(ranges, key=lambda e: e[2] - e[1])[0] if ranges else "-"
            cause = f"{outer} / {inner}"
            by_cause[cause] = by_cause.get(cause, 0.0) + (b - a)
        return sorted(by_cause.items(), key=lambda kv: -kv[1])


def _capture(task: Any, device: torch.device, epochs: int) -> Tuple[Any, Dict[str, int]]:
    """One capture; returns the profiler and the registry kernels' launches counted in its traced step."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    from metrics_tpu_torch.ops import registry

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1), acc_events=True)
    task.mark = record_function
    try:
        with prof:
            for step in range(2):
                time.sleep(PAD_S)
                before = registry.launches()
                with record_function("portbench.window"):
                    for _ in range(1 if step == 0 else epochs):
                        task.epoch()
                    torch.cuda.synchronize(device)
                counted = {k: n - before.get(k, 0) for k, n in registry.launches().items() if n > before.get(k, 0)}
                time.sleep(PAD_S)
                prof.step()
    finally:
        task.mark = lambda name: contextlib.nullcontext()
    return prof, counted


def profile(task: Any, device: torch.device, reading: Reading, epoch_s: float) -> None:
    """Trace ``PROFILE_S`` of whole epochs into ``reading``, taking the capture again, up to ``TRIES``
    times in all, while it holds fewer launches of a registry kernel than the program counted."""
    epochs = max(1, math.ceil(PROFILE_S / max(epoch_s, 1e-3)))
    short = "no capture"
    for _ in range(TRIES):
        prof, counted = _capture(task, device, epochs)
        events = prof.events()
        window = [e for e in events if e.name == "portbench.window" and not str(e.device_type).endswith("CUDA")]
        if not window:
            continue
        w0, w1 = window[-1].time_range.start, window[-1].time_range.end
        ops, host = [], []
        for e in events:
            start, end = e.time_range.start, e.time_range.end
            if str(e.device_type).endswith("CUDA"):
                if not e.is_user_annotation and end > w0 and start < w1:
                    ops.append((e.name, max(start, w0), min(end, w1)))
            elif end > w0 and start < w1 and e.name != "portbench.window":
                host.append((e.name, start, end))
        reading.ops, reading.host, reading.window, reading.epochs = ops, host, (w0, w1), epochs
        traced = reading.launches()
        missing = {k: (traced.get(k, 0), n) for k, n in counted.items() if k in reading.kernels and traced.get(k, 0) < n}
        if ops and not missing:
            return
        short = f"{len(ops)} device operations; registry launches traced/counted {missing}"
    reading.ops, reading.host, reading.window = [], [], None
    raise RuntimeError(f"no whole device trace in {TRIES} captures ({short})")
