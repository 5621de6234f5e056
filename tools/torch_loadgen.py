#!/usr/bin/env python
"""Open-loop load harness for the PyTorch port's sharded serving fabric.

The port's counterpart of ``tools/loadgen.py``, on ``metrics_tpu_torch``
alone. The shards' state lives on ``--device`` (``cuda`` unless
``--device cpu`` is given).

Usage::

    python tools/torch_loadgen.py                 # short deterministic lane
        # (~4k events over 4 in-process shards, 2x overload, structural
        # checks enforced, JSON report to stdout)
    python tools/torch_loadgen.py --events 200000 --sessions 100000 \
        --shards 8 --overload 2.0                 # capacity run
    python tools/torch_loadgen.py --subprocess --kill-shard 1 \
        --data-dir /tmp/fleet                     # one OS process per
        # shard; SIGKILL shard 1 mid-stream, then fence + replay its
        # journal on a peer and report failover-to-first-result ms
    python tools/torch_loadgen.py --worker K ...        # internal: subprocess
        # shard entry point (spawned by --subprocess, not by hand)
    python tools/torch_loadgen.py --add-shard-at 400 --remove-shard-at 800 \
        --partition 1                             # elastic drill: scale
        # out, scale in, and partition one shard mid-stream; every
        # admitted request must land
        # exactly once — the run replays the admitted stream into an
        # unsharded control twin and exits non-zero on any digest
        # mismatch (lost or double-applied updates)
    python tools/torch_loadgen.py --device cpu    # the same on the CPU

The traffic model is **open-loop**: arrival times are drawn up front
from the seeded trace (Pareto inter-arrivals — heavy-tailed bursts —
with Zipf session popularity — hot-key skew) and submits fire at those
times whether or not the fleet keeps up. Offered load does not back off
when the service sheds, which is the regime bounded queues + admission
policies exist for; closed-loop harnesses can't produce it. The same
``--seed`` replays the identical trace (same sessions, same batches,
same arrival schedule), so runs are comparable across commits.

Phases: **calibrate** (short max-rate burst through the fabric to
measure sustained capacity) → **overload** (offered rate =
``--overload`` x calibrated capacity, paced open-loop) → report.

Structural checks (``--check``, on by default — exit 1 on violation):

* **per-shard coalesced launches** — every stacked launch span's owner
  carries exactly one ``@shard<k>`` tag, and every shard that received
  traffic launched at least once (no shard serves another's rows);
* **bounded queues** — sampled queue depth never exceeds ``--max-queue``
  on any shard, even at 2x overload (overflow sheds, it never grows);
* **zero cross-shard collectives on the submit path** — the
  ``collective:*`` telemetry counters are flat across the entire run.

The JSON report carries ``sustained_updates_per_sec``,
``shed_rate_2x_overload``, ``p99_ms_2x_overload`` and
``failover_to_first_result_ms``, plus per-shard launch and serve counts,
and names the device the shards ran on.
"""
import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402


# ----------------------------------------------------------------- the trace
def make_trace(
    seed: int, sessions: int, events: int, zipf_a: float = 1.2, pareto_a: float = 2.0
) -> Dict[str, np.ndarray]:
    """The replayable traffic trace: per-event session index (Zipf — a
    few sessions take most of the traffic) and unit-mean inter-arrival
    gaps (Pareto — heavy-tailed bursts). Pure function of the seed."""
    rng = np.random.default_rng(seed)
    sess = (rng.zipf(zipf_a, size=events) - 1) % sessions
    gaps = rng.pareto(pareto_a, size=events).astype(np.float64)
    gaps /= max(gaps.mean(), 1e-12)  # unit mean: scale by 1/rate to pace
    return {"session": sess.astype(np.int64), "gaps": gaps}


def make_batches(
    seed: int, pool: int, batch: int, num_classes: int
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Fixed pool of (preds, targets) batches — one shape, so each shard
    compiles exactly one stacked signature."""
    rng = np.random.default_rng(seed + 1)
    return [
        (
            rng.integers(0, num_classes, size=batch, dtype=np.int32),
            rng.integers(0, num_classes, size=batch, dtype=np.int32),
        )
        for _ in range(pool)
    ]


def _percentile_ms(slo_totals: Dict[str, Any], q: str) -> float:
    return float(slo_totals.get("e2e_us", {}).get(q, 0.0)) / 1e3


def _device(args: argparse.Namespace) -> Any:
    """The shards' device: the card unless ``--device`` says otherwise (a
    missing card fails here, never falls back to the CPU)."""
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible; pass --device cpu to run on the CPU")
    return dev


def _device_name(dev: Any) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _on(dev: Any, batches: List[Tuple[np.ndarray, np.ndarray]]) -> List[Tuple[Any, Any]]:
    """The batch pool as tensors on ``dev``, moved once."""
    import torch

    return [(torch.from_numpy(p).to(dev), torch.from_numpy(t).to(dev)) for p, t in batches]


# ----------------------------------------------------------- in-process mode
def run_inproc(args: argparse.Namespace) -> Dict[str, Any]:
    from contextlib import ExitStack

    from metrics_tpu_torch import faults, telemetry
    from metrics_tpu_torch.classification import Accuracy
    from metrics_tpu_torch.fabric import ShardedMetricsService
    from metrics_tpu_torch.serve import QueueFullError

    dev = _device(args)
    trace = make_trace(args.seed, args.sessions, args.events)
    batches = _on(dev, make_batches(args.seed, args.batch_pool, args.batch, args.num_classes))
    names = [f"s{i:06d}" for i in range(args.sessions)]

    elastic = (
        args.add_shard_at is not None
        or args.remove_shard_at is not None
        or args.partition is not None
    )
    tmp_fleet = None
    if (args.kill_shard is not None or elastic) and not args.data_dir:
        # failover / hand-off replays and fences per-shard journals, so
        # the drills need durable per-shard state even in-process
        tmp_fleet = tempfile.TemporaryDirectory(prefix="loadgen-fleet-")
        args.data_dir = tmp_fleet.name

    # the elastic drill's contract is exactly-once over ADMITTED requests,
    # so it admits everything (blocking admission, no queue bound) and the
    # ledger replays the full submitted stream into a control twin; the
    # plain overload lane keeps shed-oldest + the bounded-queue pin
    fab = ShardedMetricsService(
        Accuracy(task="multiclass", num_classes=args.num_classes, device=dev),
        num_shards=args.shards,
        data_dir=args.data_dir,
        standby=elastic,
        max_queue=None if elastic else args.max_queue,
        admission="block" if elastic else "shed-oldest",
        flush_interval_s=args.flush_interval_s,
    )
    ledger: List[Tuple[str, int]] = []  # (session, batch idx) per admitted submit

    report: Dict[str, Any] = {
        "mode": "inproc",
        "device": _device_name(dev),
        "seed": args.seed,
        "shards": args.shards,
        "sessions": args.sessions,
        "events": args.events,
        "overload": args.overload,
    }
    collectives_before = {
        k: v for k, v in telemetry.snapshot().items() if k.startswith("collective")
    }

    with telemetry.instrument() as tel:
        # -- warm up: compile every shard's stacked program out-of-band ----
        for k in range(args.shards):
            probe = next(n for n in names if fab.shard_for(n) == k)
            fab.submit(probe, *batches[0])
            if elastic:
                ledger.append((probe, 0))
        fab.drain()

        # -- calibrate: repeated max-rate bursts; the last one runs with
        # every coalesce bucket already compiled, so its rate is the warm
        # sustained capacity (earlier bursts are dominated by bucket
        # growth retraces and would understate it badly)
        n_cal = max(64, args.events // 4)
        capacity = 0.0
        for _ in range(args.cal_bursts):
            t0 = time.perf_counter()
            for i in range(n_cal):
                sid = int(trace["session"][i])
                p, t = batches[i % len(batches)]
                try:
                    fab.submit(names[sid], p, t)
                    if elastic:
                        ledger.append((names[sid], i % len(batches)))
                except QueueFullError:
                    pass
            fab.drain()
            capacity = n_cal / max(time.perf_counter() - t0, 1e-9)
        report["sustained_updates_per_sec"] = round(capacity, 1)

        # -- overload: open-loop pacing at overload x capacity -------------
        rate = args.overload * capacity
        arrivals = np.cumsum(trace["gaps"]) / rate
        max_depth = 0
        rejected = 0
        kill_at = args.events // 2 if args.kill_shard is not None else None
        partition_at = args.events // 2 if args.partition is not None else None
        pre_totals = dict(fab.fleet_snapshot()["serve_totals"])
        with telemetry.instrument() as otel, ExitStack() as drills:
            t_start = time.perf_counter()
            for i in range(args.events):
                target = t_start + float(arrivals[i])
                while True:
                    now = time.perf_counter()
                    if now >= target:
                        break
                    time.sleep(min(1e-3, target - now))
                if kill_at is not None and i == kill_at:
                    fab.kill_shard(args.kill_shard)
                if args.add_shard_at is not None and i == args.add_shard_at:
                    # scale-out mid-stream: drain -> fence -> transfer ->
                    # swap; time to the first result off a moved session
                    t_h = time.perf_counter()
                    new_sid = fab.add_shard()
                    moved = fab.rebalance()["moved"]
                    if moved:
                        fab.compute(moved[0])
                    report["handoff_first_result_ms"] = round(
                        (time.perf_counter() - t_h) * 1e3, 3
                    )
                    report["added_shard"] = new_sid
                    report["handoff_moved_sessions"] = len(moved)
                if args.remove_shard_at is not None and i == args.remove_shard_at:
                    victim = args.shards - 1  # retire the last seed shard
                    moved = fab.remove_shard(victim)
                    report["removed_shard"] = victim
                    report["remove_moved_sessions"] = len(moved)
                if partition_at is not None and i == partition_at:
                    # both sides think they own the range from here: the
                    # next route to the victim fences + fails over, and
                    # the old owner's writes raise StaleEpochError
                    drills.enter_context(faults.inject(
                        "network-partition", prob=1.0, count=1,
                        shard=args.partition,
                    ))
                if elastic and i % 251 == 0:
                    fab.replicate()  # keep the standbys warm mid-stream
                sid = int(trace["session"][i])
                p, t = batches[i % len(batches)]
                try:
                    fab.submit(names[sid], p, t)
                    if elastic:
                        ledger.append((names[sid], i % len(batches)))
                except QueueFullError:
                    rejected += 1
                if i % 97 == 0:  # bounded-queue check: sample depths under load
                    for sh in fab.health()["shards"].values():
                        max_depth = max(max_depth, int(sh.get("queue_depth", 0)))
            overload_s = time.perf_counter() - t_start
            fab.drain()

    # -- fold the fleet ----------------------------------------------------
    snap = fab.fleet_snapshot()
    totals = snap["serve_totals"]

    def _overload_delta(key: str) -> int:
        return int(totals.get(key, 0)) - int(pre_totals.get(key, 0))

    shed = _overload_delta("shed_requests") + _overload_delta("expired_requests")
    served = _overload_delta("submits") - shed - _overload_delta("failed_requests")
    report["offered"] = args.events
    report["served"] = served
    report["shed"] = shed + rejected
    report["shed_rate_2x_overload"] = round((shed + rejected) / max(args.events, 1), 4)
    report["overload_wall_s"] = round(overload_s, 3)
    durs = sorted(
        e.dur_us for e in otel.spans(name="request", kind="served") if e.dur_us
    )
    p99 = durs[min(len(durs) - 1, int(round(0.99 * (len(durs) - 1))))] if durs else 0.0
    report["p99_ms_2x_overload"] = round(p99 / 1e3, 3)
    # dollar attribution at overload: the integer-microdollar deltas over
    # the overload window render to $ and $/M-updates (microdollars per
    # billed update IS dollars per million updates); zeros with
    # METRICS_TPU_BILLING=0
    cost_micro = _overload_delta("cost_microusd")
    billed = _overload_delta("billed_requests")
    report["cost_usd_2x_overload"] = round(cost_micro / 1e6, 6)
    report["usd_per_million_updates"] = (
        round(cost_micro / billed, 4) if billed else 0.0
    )
    report["max_queue_depth_sampled"] = max_depth
    report["queue_bound"] = None if elastic else args.max_queue
    report["failover_events"] = snap["failover_events"]
    report["failover_causes"] = snap["failover_causes"]
    unplanned = [e for e in snap["failover_events"] if e["cause"] != "planned"]
    if unplanned:
        report["failover_to_first_result_ms"] = unplanned[0]["ms"]
        if unplanned[0].get("standby"):
            report["replicated_failover_ms"] = unplanned[0]["ms"]

    launches: Dict[str, int] = {}
    for e in tel.spans(name="update", kind="stacked-aot"):
        launches[e.owner] = launches.get(e.owner, 0) + 1
    report["launches_by_owner"] = launches
    collectives_after = {
        k: v for k, v in telemetry.snapshot().items() if k.startswith("collective")
    }
    report["submit_collectives"] = sum(collectives_after.values()) - sum(
        collectives_before.values()
    )
    report["coalesced_requests"] = int(totals.get("coalesced_requests", 0))

    # -- structural checks ---------------------------------------------------
    violations: List[str] = []
    if args.check:
        for owner in launches:
            if "@shard" not in owner:
                violations.append(f"launch span without shard tag: {owner}")
        launched_shards = {
            int(owner.rsplit("@shard", 1)[1]) for owner in launches if "@shard" in owner
        }
        if not elastic:
            # (skipped under the elastic drill: membership changed
            # mid-run, so "which shard got traffic" has no single answer
            # — the exactly-once ledger below is the real check there)
            traffic_shards = {fab.shard_for(names[int(s)]) for s in trace["session"]}
            missing = traffic_shards - launched_shards - (
                {args.kill_shard} if args.kill_shard is not None else set()
            )
            if missing:
                violations.append(
                    f"shards with traffic but zero launches: {sorted(missing)}"
                )
        if not elastic and args.max_queue and max_depth > args.max_queue:
            violations.append(
                f"queue bound violated: sampled depth {max_depth} > {args.max_queue}"
            )
        if report["submit_collectives"] != 0:
            violations.append(
                f"cross-shard collectives on submit path: {report['submit_collectives']}"
            )
        if (shed + rejected == 0 and args.overload >= 1.5
                and args.kill_shard is None and not elastic):
            # (skipped under --kill-shard: failover replaces the victim's
            # service, so the overload-phase counter deltas go dark; the
            # elastic drill admits everything by design)
            violations.append("no shedding at >=1.5x overload: queue bound inert?")

    # -- exactly-once ledger (elastic drill) -------------------------------
    if elastic and args.check:
        # replay every admitted submit into one unsharded control twin:
        # after any mix of hand-offs, retirements, and partition failovers,
        # every session's value must match bit-for-bit — a lost update or
        # a double-apply shows up as a digest mismatch
        from metrics_tpu_torch.serve import MetricsService

        ref = MetricsService(
            Accuracy(task="multiclass", num_classes=args.num_classes, device=dev)
        )
        for name, bi in ledger:
            ref.submit(name, *batches[bi])
        ref.drain()
        want = {k: v.cpu().numpy().tobytes() for k, v in ref.compute_all().items()}
        got = {k: v.cpu().numpy().tobytes() for k, v in fab.compute_all().items()}
        ref.shutdown()
        report["ledger_submits"] = len(ledger)
        report["ledger_sessions"] = len(want)
        for name in sorted(set(want) - set(got)):
            violations.append(f"ledger: session {name} lost in hand-off")
        for name in sorted(set(got) - set(want)):
            violations.append(f"ledger: phantom session {name} after hand-off")
        mismatched = sorted(
            n for n in set(want) & set(got) if want[n] != got[n]
        )
        for name in mismatched[:8]:
            violations.append(
                f"ledger: session {name} digest mismatch "
                "(lost or double-applied admitted request)"
            )
        if len(mismatched) > 8:
            violations.append(f"ledger: ... and {len(mismatched) - 8} more")
    report["violations"] = violations
    _ = faults  # keep the fault registry imported for env-armed runs
    fab.shutdown()
    if tmp_fleet is not None:
        tmp_fleet.cleanup()
    return report


# ---------------------------------------------------------- subprocess mode
def _worker_env() -> Dict[str, str]:
    env = dict(os.environ)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return env


def run_worker(args: argparse.Namespace) -> int:
    """Subprocess shard entry point: replay this shard's partition of the
    shared trace (the ring is a pure function of the seedless session
    names, so parent and workers agree with zero coordination)."""
    from metrics_tpu_torch import wal
    from metrics_tpu_torch.classification import Accuracy
    from metrics_tpu_torch.fabric import HashRing
    from metrics_tpu_torch.serve import MetricsService, QueueFullError

    k = args.worker
    dev = _device(args)
    trace = make_trace(args.seed, args.sessions, args.events)
    batches = _on(dev, make_batches(args.seed, args.batch_pool, args.batch, args.num_classes))
    ring = HashRing(list(range(args.shards)))
    names = [f"s{i:06d}" for i in range(args.sessions)]
    mine = np.array([ring.owner(n) == k for n in names], dtype=bool)

    root = os.path.join(args.data_dir, f"shard-{k:02d}")
    journal_dir = os.path.join(root, "wal")
    svc = MetricsService(
        Accuracy(task="multiclass", num_classes=args.num_classes, device=dev),
        journal_dir=journal_dir,
        checkpoint_dir=os.path.join(root, "ckpt"),
        shard_id=k,
        rid_offset=k,
        rid_stride=args.shards,
        epoch=wal.read_epoch(journal_dir) + 1,
        max_queue=args.max_queue,
        admission="shed-oldest",
    )
    served = 0
    t0 = time.perf_counter()
    for i in range(args.events):
        sid = int(trace["session"][i])
        if not mine[sid]:
            continue
        p, t = batches[i % len(batches)]
        try:
            svc.submit(names[sid], p, t)
        except QueueFullError:
            pass
        served += 1
        if served % args.flush_every == 0:
            svc.flush()
    svc.drain()
    elapsed = time.perf_counter() - t0
    svc.checkpoint()
    snap = svc.telemetry_snapshot()
    print(
        json.dumps(
            {
                "shard": k,
                "events": served,
                "updates_per_sec": round(served / max(elapsed, 1e-9), 1),
                "sessions": snap["sessions"],
                "launches": int(snap["serve"].get("launches", 0)),
                "shed": int(snap["serve"].get("shed_requests", 0)),
                "last_seq": (snap["wal"] or {}).get("last_seq"),
            }
        ),
        flush=True,
    )
    svc.shutdown()
    return 0


def run_subprocess(args: argparse.Namespace) -> Dict[str, Any]:
    """One OS process per shard — the real multi-host shape. With
    ``--kill-shard K`` the parent SIGKILLs shard K mid-stream (a genuine
    dead host: torn journal tail and all), then runs the failover drill:
    fence the dead shard's epoch, replay its journal on a fresh service,
    and time to the first recovered ``compute``."""
    from metrics_tpu_torch import wal
    from metrics_tpu_torch.classification import Accuracy
    from metrics_tpu_torch.fabric import HashRing
    from metrics_tpu_torch.serve import MetricsService

    dev = _device(args)
    if not args.data_dir:
        raise SystemExit("--subprocess needs --data-dir (per-shard journals)")
    os.makedirs(args.data_dir, exist_ok=True)
    ring = HashRing(list(range(args.shards)))
    names = [f"s{i:06d}" for i in range(args.sessions)]

    base_cmd = [
        sys.executable, os.path.abspath(__file__),
        "--seed", str(args.seed), "--sessions", str(args.sessions),
        "--events", str(args.events), "--shards", str(args.shards),
        "--batch", str(args.batch), "--batch-pool", str(args.batch_pool),
        "--num-classes", str(args.num_classes), "--max-queue", str(args.max_queue),
        "--flush-every", str(args.flush_every), "--data-dir", args.data_dir,
        "--device", args.device,
    ]
    procs = {
        k: subprocess.Popen(
            base_cmd + ["--worker", str(k)],
            stdout=subprocess.PIPE, text=True, env=_worker_env(),
        )
        for k in range(args.shards)
    }
    killed_rc = None
    if args.kill_shard is not None:
        time.sleep(args.kill_delay_s)
        victim = procs[args.kill_shard]
        victim.send_signal(signal.SIGKILL)
        killed_rc = victim.wait()

    per_shard: Dict[int, Any] = {}
    for k, proc in procs.items():
        out, _ = proc.communicate(timeout=args.worker_timeout_s)
        if k == args.kill_shard:
            continue
        if proc.returncode != 0:
            raise SystemExit(f"worker {k} failed rc={proc.returncode}: {out}")
        per_shard[k] = json.loads(out.strip().splitlines()[-1])

    report: Dict[str, Any] = {
        "mode": "subprocess",
        "device": _device_name(dev),
        "seed": args.seed,
        "shards": args.shards,
        "events": args.events,
        "per_shard": per_shard,
        "sustained_updates_per_sec": round(
            sum(s["updates_per_sec"] for s in per_shard.values()), 1
        ),
    }

    if args.kill_shard is not None:
        k = args.kill_shard
        report["killed_shard"] = k
        report["killed_rc"] = killed_rc
        root = os.path.join(args.data_dir, f"shard-{k:02d}")
        journal_dir = os.path.join(root, "wal")
        probe = next(n for n in names if ring.owner(n) == k)
        t0 = time.perf_counter()
        new_epoch = wal.read_epoch(journal_dir) + 1
        wal.fence_epoch(journal_dir, new_epoch)  # fence FIRST, then replay
        svc = MetricsService(
            Accuracy(task="multiclass", num_classes=args.num_classes, device=dev),
            journal_dir=journal_dir,
            checkpoint_dir=os.path.join(root, "ckpt"),
            shard_id=k, rid_offset=k, rid_stride=args.shards, epoch=new_epoch,
        )
        svc.recover()
        first = svc.compute(probe) if svc.session_count else None
        ms = (time.perf_counter() - t0) * 1e3
        report["failover_to_first_result_ms"] = round(ms, 3)
        report["recovered_sessions"] = svc.session_count
        report["recovered_epoch"] = new_epoch
        report["first_result"] = None if first is None else float(first)
        svc.shutdown()
    return report


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="the shards' device (cuda or cpu)")
    ap.add_argument("--sessions", type=int, default=128)
    ap.add_argument("--events", type=int, default=4000)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--overload", type=float, default=2.0,
                    help="offered rate as a multiple of calibrated capacity")
    ap.add_argument("--cal-bursts", type=int, default=3,
                    help="calibration bursts (last one is the measurement)")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--batch-pool", type=int, default=64)
    ap.add_argument("--num-classes", type=int, default=10)
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--flush-interval-s", type=float, default=0.02)
    ap.add_argument("--flush-every", type=int, default=64,
                    help="worker mode: flush every N local submits")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--subprocess", action="store_true",
                    help="one OS process per shard")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--kill-shard", type=int, default=None,
                    help="SIGKILL this shard mid-stream, then fail over")
    ap.add_argument("--add-shard-at", type=int, default=None,
                    help="elastic drill: add_shard() + rebalance() at this "
                         "event index (in-process mode)")
    ap.add_argument("--remove-shard-at", type=int, default=None,
                    help="elastic drill: remove_shard(shards-1) at this "
                         "event index (in-process mode)")
    ap.add_argument("--partition", type=int, default=None,
                    help="elastic drill: network-partition this shard at "
                         "events/2; the fabric must fence + fail over and "
                         "the old side's writes must bounce")
    ap.add_argument("--kill-delay-s", type=float, default=2.0)
    ap.add_argument("--worker-timeout-s", type=float, default=600.0)
    ap.add_argument("--check", dest="check", action="store_true", default=True,
                    help="enforce the structural checks (default)")
    ap.add_argument("--no-check", dest="check", action="store_false")
    ap.add_argument("--out", default=None, help="write the JSON report here too")
    args = ap.parse_args(argv)

    if args.worker is not None:
        return run_worker(args)
    report = run_subprocess(args) if args.subprocess else run_inproc(args)
    text = json.dumps(report, indent=2, sort_keys=True)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    if report.get("violations"):
        print(f"FAIL: {len(report['violations'])} structural violation(s)",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
