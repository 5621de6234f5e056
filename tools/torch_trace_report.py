#!/usr/bin/env python
"""Replay a telemetry JSON-lines export of the port into a human-readable summary.

Usage::

    python tools/torch_trace_report.py TRACE.jsonl          # summarize an export
    python tools/torch_trace_report.py --bench TRACE.jsonl  # run a short
        # instrumented eval (10 fused-collection forward steps + compute) on
        # --device (cuda by default), write TRACE.jsonl (and TRACE.trace.json
        # for Perfetto), then summarize it

The counterpart of ``tools/trace_report.py`` with no JAX: the input is what
``metrics_tpu_torch.telemetry.export_jsonl`` (or a session's
``export_jsonl``) writes, one JSON object an event with
``name``/``owner``/``kind``/``ts_us``/``dur_us``/``attrs``, and the summary
is the JAX tool's, line for line: launches of each flavor, why every
program was built (and whether the static audit, ``STATIC_AUDIT_TORCH.json``,
predicted it), what crossed the wire, the roofline ranking whose kernel
column is :func:`metrics_tpu_torch.ops.kernel_status`, and the p50/p95 of
each span family.
"""
import argparse
import json
import os
import sys
from typing import Any, Dict, List, Tuple

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an ascending list (no numpy needed)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def load_events(path: str) -> List[Dict[str, Any]]:
    events = []
    with open(path) as f:
        for line_no, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                event = json.loads(line)
            except json.JSONDecodeError as err:
                raise SystemExit(f"{path}:{line_no}: not a telemetry JSONL line ({err})")
            # a truncated tail can still parse (e.g. a bare number) — every
            # telemetry record is an object with at least a span name
            if not isinstance(event, dict) or "name" not in event:
                raise SystemExit(
                    f"{path}:{line_no}: not a telemetry JSONL line (no span name)"
                )
            events.append(event)
    return events


def summarize(events: List[Dict[str, Any]]) -> str:
    """Render the report the bench trajectory reads: launches by
    (name, kind), retraces by cause, collectives + wire bytes, and
    p50/p95 span µs per family."""
    lines: List[str] = []
    if not events:
        return "(empty trace: no telemetry events)"

    span_start = min(e.get("ts_us", 0.0) for e in events)
    span_end = max(e.get("ts_us", 0.0) + e.get("dur_us", 0.0) for e in events)
    lines.append(f"events: {len(events)}   trace window: {(span_end - span_start) / 1000.0:.2f} ms")

    # launches / phases by (name, kind)
    groups: Dict[str, List[Dict[str, Any]]] = {}
    for e in events:
        key = f"{e['name']}:{e['kind']}" if e.get("kind") else e["name"]
        groups.setdefault(key, []).append(e)

    lines.append("")
    lines.append(f"{'span':<28}{'count':>7}{'p50 us':>12}{'p95 us':>12}{'total us':>14}")
    for key in sorted(groups):
        durs = sorted(e.get("dur_us", 0.0) for e in groups[key])
        lines.append(
            f"{key:<28}{len(durs):>7}{_percentile(durs, 50):>12.1f}"
            f"{_percentile(durs, 95):>12.1f}{sum(durs):>14.1f}"
        )

    compiles = [e for e in events if e["name"] == "compile"]
    lines.append("")
    lines.append(f"retraces: {len(compiles)}")
    causes: Dict[str, int] = {}
    for e in compiles:
        cause = (e.get("attrs") or {}).get("cause", "unattributed")
        causes[cause] = causes.get(cause, 0) + 1
    for cause in sorted(causes):
        lines.append(f"  cause {cause:<22}{causes[cause]:>5}")

    # predicted vs observed: the static audit (STATIC_AUDIT_TORCH.json's hazard
    # table, served by metrics_tpu_torch.analysis.hazards) stamps `predicted`
    # onto compile spans whose cause class it models (static-key /
    # signature flips). An `unpredicted` rebuild means the audit's model
    # of that owner is stale: rerun tools/torch_static_audit.py.
    attributable = [
        e for e in compiles
        if "predicted" in (e.get("attrs") or {})
    ]
    if attributable:
        predicted = sum(1 for e in attributable if (e.get("attrs") or {}).get("predicted"))
        lines.append(f"  predicted by static audit: {predicted}/{len(attributable)}")
        unpredicted: Dict[str, int] = {}
        for e in attributable:
            if not (e.get("attrs") or {}).get("predicted"):
                key = f"{e.get('owner', '?')}:{(e.get('attrs') or {}).get('cause', '?')}"
                unpredicted[key] = unpredicted.get(key, 0) + 1
        for key in sorted(unpredicted):
            lines.append(f"  UNPREDICTED {key:<28}{unpredicted[key]:>5}  (stale audit?)")

    collectives = [e for e in events if e["name"] == "collective"]
    total_bytes = sum(int((e.get("attrs") or {}).get("nbytes", 0)) for e in collectives)
    # logical_nbytes = the bytes the same payload would cost at full
    # precision (spans without the attr count their wire bytes — a 1.0x
    # ratio); wire < logical means the quantized / narrowed wire paid off
    total_logical = sum(
        int((e.get("attrs") or {}).get("logical_nbytes",
                                       (e.get("attrs") or {}).get("nbytes", 0)))
        for e in collectives
    )
    lines.append("")
    ratio = (total_logical / total_bytes) if total_bytes else 1.0
    lines.append(
        f"collectives: {len(collectives)}   bytes on wire: {total_bytes}"
        f"   logical: {total_logical}   compression: {ratio:.2f}x"
    )
    by_kind: Dict[str, List[Tuple[int, int]]] = {}
    for e in collectives:
        a = e.get("attrs") or {}
        nb = int(a.get("nbytes", 0))
        by_kind.setdefault(e.get("kind", "?"), []).append(
            (nb, int(a.get("logical_nbytes", nb)))
        )
    for kind in sorted(by_kind):
        wire = sum(w for w, _l in by_kind[kind])
        logical = sum(l for _w, l in by_kind[kind])
        kr = (logical / wire) if wire else 1.0
        lines.append(
            f"  {kind:<12}{len(by_kind[kind]):>5} launches, {wire:>10} bytes"
            f"  ({kr:.2f}x compression)"
        )

    # roofline attribution (metrics_tpu_torch.analysis.cost_model): every launch
    # span that rode a cost-registry entry carries model flops/bytes and
    # achieved rates. Configs rank by DISTANCE to the roofline: the
    # farthest-from-ceiling bandwidth-bound configs are kernel targets. On a
    # device in the peak table the fraction is absolute; elsewhere it is
    # relative to the best achieved rate in this trace (structural
    # ordering, advisory magnitudes).
    costed = [
        e for e in events
        if (e.get("attrs") or {}).get("model_flops") is not None
    ]
    if costed:
        # kernel column: the ops/ registry's verdict per row — `yes` when
        # the owner's programs engaged a registered CUDA kernel (or the
        # row IS an ops.* kernel launch), `eligible` when a registered
        # kernel covers the owner but was not engaged (a kernelization
        # target), `no` otherwise (metrics_tpu_torch/ops/registry.py).
        from metrics_tpu_torch.ops import registry as ops_registry

        by_cfg: Dict[str, List[Dict[str, Any]]] = {}
        for e in costed:
            cfg = f"{e.get('owner', '?')}:{e.get('kind', '?')}"
            by_cfg.setdefault(cfg, []).append(e)
        rows = []
        for cfg, evs in by_cfg.items():
            a0 = evs[0].get("attrs") or {}
            best_gflops = max(float((e.get("attrs") or {}).get("achieved_gflops", 0.0)) for e in evs)
            best_gbps = max(float((e.get("attrs") or {}).get("achieved_gbps", 0.0)) for e in evs)
            frac = max(float((e.get("attrs") or {}).get("roofline_frac", 0.0)) for e in evs)
            rows.append({
                "cfg": cfg,
                "n": len(evs),
                "flops": float(a0.get("model_flops", 0.0)),
                "bytes": float(a0.get("model_bytes", 0.0)),
                "intensity": float(a0.get("intensity", 0.0)),
                "regime": str(a0.get("regime", "?")),
                "basis": str(a0.get("roofline_basis", "relative")),
                "gflops": best_gflops,
                "gbps": best_gbps,
                "frac": frac,
                "kernel": ops_registry.kernel_status(
                    str(evs[0].get("owner", "?")), str(evs[0].get("kind", "?"))
                ),
            })
        # relative basis: normalize each regime's wall against the best
        # achieved rate for that wall anywhere in this trace
        top_gbps = max((r["gbps"] for r in rows), default=0.0)
        top_gflops = max((r["gflops"] for r in rows), default=0.0)
        for r in rows:
            if r["basis"] != "absolute" or r["frac"] <= 0.0:
                if r["regime"] == "compute-bound" and top_gflops > 0:
                    r["frac"] = r["gflops"] / top_gflops
                elif top_gbps > 0:
                    r["frac"] = r["gbps"] / top_gbps
        rows.sort(key=lambda r: (1.0 - r["frac"], -r["bytes"]), reverse=True)
        basis = rows[0]["basis"] if rows else "relative"
        lines.append("")
        lines.append(f"roofline ({basis} basis), ranked by distance to roofline:")
        lines.append(
            f"  {'config':<36}{'launches':>9}{'intensity':>11}  {'regime':<16}"
            f"{'GB/s':>9}{'GFLOP/s':>10}{'of roof':>9}  {'kernel':<8}"
        )
        for r in rows:
            lines.append(
                f"  {r['cfg']:<36}{r['n']:>9}{r['intensity']:>11.3f}  {r['regime']:<16}"
                f"{r['gbps']:>9.2f}{r['gflops']:>10.2f}{100.0 * r['frac']:>8.1f}%"
                f"  {r['kernel']:<8}"
            )

    # persistent program cache (the JAX package's aot_cache; the port has
    # none, so its traces count zeros here) + in-process LRU evictions
    cache = {e.get("kind", "?"): 0 for e in events if e["name"] == "aot-cache"}
    for e in events:
        if e["name"] == "aot-cache":
            cache[e.get("kind", "?")] += 1
    evictions = sum(1 for e in events if e["name"] == "evict")
    lines.append("")
    lines.append(
        "persistent cache: "
        + "   ".join(
            f"{k}: {cache.get(k, 0)}" for k in ("hit", "miss", "store", "corrupt")
        )
        + f"   evictions: {evictions}"
    )

    # write-ahead journal + admission control (metrics_tpu_torch.wal + serve):
    # appends are the per-request durability tax, replay/truncate bracket
    # recovery, and every degraded request carries its admission cause
    journal = [e for e in events if e["name"] == "journal"]
    if journal:
        by_jkind: Dict[str, int] = {}
        for e in journal:
            by_jkind[e.get("kind", "?")] = by_jkind.get(e.get("kind", "?"), 0) + 1
        jbytes = sum(int((e.get("attrs") or {}).get("nbytes", 0)) for e in journal)
        replayed = sum(int((e.get("attrs") or {}).get("records", 0)) for e in journal
                       if e.get("kind") == "replay")
        lines.append("")
        lines.append(
            "journal: "
            + "   ".join(f"{k}: {by_jkind.get(k, 0)}" for k in ("append", "replay", "truncate"))
            + f"   bytes appended: {jbytes}   records replayed: {replayed}"
        )
    # streaming subsystem (metrics_tpu_torch.streaming): ring advances vs plain
    # bucket accumulates, window reads with live-bucket counts, and sketch
    # traffic by class — all eager-path spans (traced streams are silent)
    windows = [e for e in events if e["name"] == "window"]
    if windows:
        by_wkind: Dict[str, int] = {}
        for e in windows:
            by_wkind[e.get("kind", "?")] = by_wkind.get(e.get("kind", "?"), 0) + 1
        lines.append("")
        lines.append(
            "window ops: "
            + "   ".join(
                f"{k}: {by_wkind.get(k, 0)}"
                for k in ("advance", "update", "compute", "serve-compute")
            )
        )
    # the O(1) read path (serve memo + window prefix cache + packed fleet
    # reads): hit rate answers "are dashboards actually free?", the
    # dirty-row histogram shows how much of each compute_all launched, and
    # fleet-read percentiles pin the one-collective fan-in latency
    reads = [e for e in events if e["name"] == "read"]
    if reads:
        by_rkind: Dict[str, int] = {}
        for e in reads:
            by_rkind[e.get("kind", "?")] = by_rkind.get(e.get("kind", "?"), 0) + 1
        hits = by_rkind.get("memo-hit", 0) + by_rkind.get("window-cached", 0)
        misses = (
            by_rkind.get("memo-miss", 0)
            + by_rkind.get("batch", 0)
            + by_rkind.get("window-rebuild", 0)
        )
        total = hits + misses
        lines.append("")
        lines.append(
            "read path: "
            + "   ".join(f"{k}: {n}" for k, n in sorted(by_rkind.items()))
        )
        if total:
            lines.append(f"  memo hit rate: {hits}/{total} ({100.0 * hits / total:.1f}%)")
        batches = [e for e in reads if e.get("kind") == "batch"]
        if batches:
            hist: Dict[int, int] = {}
            for e in batches:
                d = int((e.get("attrs") or {}).get("dirty", 0))
                hist[d] = hist.get(d, 0) + 1
            lines.append(
                "  dirty rows per batched read: "
                + "   ".join(f"{d}: {n}" for d, n in sorted(hist.items()))
            )
        fleet = sorted(
            e.get("dur_us", 0.0) for e in reads if e.get("kind") in ("fleet", "rollup")
        )
        if fleet:
            lines.append(
                f"  fleet read   p50 {_percentile(fleet, 50):>10.1f} us"
                f"   p95 {_percentile(fleet, 95):>10.1f} us"
                f"   ({len(fleet)} reads)"
            )
    sketches = [e for e in events if e["name"] == "sketch"]
    if sketches:
        by_owner: Dict[str, int] = {}
        for e in sketches:
            by_owner[e.get("owner", "?")] = by_owner.get(e.get("owner", "?"), 0) + 1
        lines.append("sketch ops: " + "   ".join(f"{o}: {n}" for o, n in sorted(by_owner.items())))
    # request flight recorder (metrics_tpu_torch.serve): one `request` span per
    # admitted submit with the end-to-end latency and its stage breakdown
    requests = [e for e in events if e["name"] == "request"]
    if requests:
        by_outcome: Dict[str, int] = {}
        for e in requests:
            by_outcome[e.get("kind", "?")] = by_outcome.get(e.get("kind", "?"), 0) + 1
        replayed_reqs = sum(1 for e in requests if (e.get("attrs") or {}).get("replayed"))
        lines.append("")
        lines.append(
            "requests: "
            + "   ".join(f"{k}: {n}" for k, n in sorted(by_outcome.items()))
            + (f"   replayed: {replayed_reqs}" if replayed_reqs else "")
        )
        e2e = sorted(e.get("dur_us", 0.0) for e in requests)
        lines.append(
            f"  {'e2e':<12}p50 {_percentile(e2e, 50):>10.1f} us"
            f"   p95 {_percentile(e2e, 95):>10.1f} us"
            f"   p99 {_percentile(e2e, 99):>10.1f} us"
        )
        for stage in ("queue_us", "journal_us", "launch_us", "retire_us"):
            vals = sorted(
                float((e.get("attrs") or {}).get(stage, 0.0)) for e in requests
            )
            lines.append(
                f"  {stage[:-3]:<12}p50 {_percentile(vals, 50):>10.1f} us"
                f"   p95 {_percentile(vals, 95):>10.1f} us"
                f"   p99 {_percentile(vals, 99):>10.1f} us"
            )

    # dollar attribution (metrics_tpu_torch.analysis.billing): launch spans carry
    # their modeled cost in integer microdollars, request spans the shares
    # apportioned back by masked-row count — the two sums must agree
    # exactly (the conservation pin). Tenants and owners rank by $;
    # $/M-updates is microdollars-per-update read off the same integers.
    # A pre-cost trace (request spans but no cost attrs anywhere) reports
    # the section as unavailable instead of inventing zeros.
    req_cost = [e for e in requests if "cost_microusd" in (e.get("attrs") or {})]
    launch_cost = [
        e for e in events
        if e["name"] != "request" and "cost_microusd" in (e.get("attrs") or {})
    ]
    if req_cost or launch_cost:
        total_req = sum(int((e.get("attrs") or {}).get("cost_microusd", 0)) for e in req_cost)
        total_launch = sum(int((e.get("attrs") or {}).get("cost_microusd", 0)) for e in launch_cost)
        conserved = (
            "conserved exactly" if total_req == total_launch
            else f"DRIFT: requests {total_req} != launches {total_launch} microusd"
        )
        lines.append("")
        lines.append(
            f"cost: ${total_launch / 1e6:.6f} over {len(launch_cost)} costed launches"
            f"   request-share sum: ${total_req / 1e6:.6f}   ({conserved})"
        )
        lines.append(
            "  rates are nominal on-demand list prices (analysis.billing."
            "DEVICE_RATES) — comparison denominators, not a bill"
        )
        by_tenant: Dict[str, List[int]] = {}
        for e in req_cost:
            a = e.get("attrs") or {}
            t = by_tenant.setdefault(str(a.get("session", "?")), [0, 0])
            t[0] += int(a.get("cost_microusd", 0))
            if e.get("kind") in ("served", "fallback"):
                t[1] += 1
        if by_tenant:
            lines.append(f"  {'tenant':<28}{'$':>12}{'updates':>9}{'$/M-updates':>13}")
            ranked = sorted(by_tenant.items(), key=lambda kv: (-kv[1][0], kv[0]))
            for tenant, (micro, updates) in ranked[:12]:
                per_m = (micro / updates) if updates else 0.0
                lines.append(
                    f"  {tenant:<28}{micro / 1e6:>12.6f}{updates:>9}{per_m:>13.4f}"
                )
            if len(ranked) > 12:
                lines.append(f"  ... {len(ranked) - 12} more tenants")
        by_owner_cost: Dict[str, List[float]] = {}
        for e in launch_cost:
            a = e.get("attrs") or {}
            key = f"{e.get('owner', '?')}:{e.get('kind', '?')}"
            o = by_owner_cost.setdefault(key, [0, 0, 0.0])
            o[0] += int(a.get("cost_microusd", 0))
            o[1] += 1
            o[2] += float(a.get("modeled_device_s", 0.0))
        if by_owner_cost:
            lines.append(f"  {'config':<36}{'$':>12}{'launches':>9}{'modeled s':>12}")
            for key, (micro, n, dev_s) in sorted(
                by_owner_cost.items(), key=lambda kv: (-kv[1][0], kv[0])
            ):
                lines.append(f"  {key:<36}{micro / 1e6:>12.6f}{n:>9}{dev_s:>12.6f}")
    elif requests:
        lines.append("")
        lines.append(
            "cost attribution: unavailable (pre-cost trace — no span carries "
            "cost_usd/modeled_device_s; re-record with METRICS_TPU_BILLING "
            "enabled for the dollar section)"
        )

    # memory gauges (serve flight recorder): the latest per-flush sample of
    # stacked-state bytes, with the largest leaves — the sharding input
    mem_gauges = [
        e for e in events if e["name"] == "gauge" and e.get("kind") == "memory"
    ]
    if mem_gauges:
        latest = max(mem_gauges, key=lambda e: e.get("ts_us", 0.0))
        attrs = latest.get("attrs") or {}
        lines.append("")
        lines.append(
            f"state memory: {attrs.get('total_bytes', 0)} bytes over "
            f"{attrs.get('leaf_count', 0)} leaves ({latest.get('owner', '?')})"
        )
        for entry in attrs.get("top", []):
            try:
                leaf_name, nbytes = entry[0], entry[1]
            except (TypeError, IndexError, KeyError):
                continue
            lines.append(f"  {str(leaf_name):<28}{nbytes:>12} bytes")

    degrades = [
        e for e in events
        if e["name"] == "degrade" and e.get("kind") in ("admission", "session")
    ]
    if degrades:
        by_cause: Dict[str, int] = {}
        for e in degrades:
            cause = (e.get("attrs") or {}).get("cause", "unattributed")
            by_cause[cause] = by_cause.get(cause, 0) + 1
        lines.append("admission degrades: " + str(len(degrades)))
        for cause in sorted(by_cause):
            lines.append(f"  cause {cause:<22}{by_cause[cause]:>5}")

    # multi-host fabric (metrics_tpu_torch.fabric): shards tag their spans with an
    # `@shard<k>` owner suffix, so a fleet trace decomposes into per-shard
    # launch/request tallies; failover spans carry shard/peer/epoch/ms and a
    # cause (killed / heartbeat / suspect-slow / partition / planned)
    shard_launches: Dict[str, int] = {}
    shard_requests: Dict[str, int] = {}
    for e in events:
        owner = str(e.get("owner", ""))
        if "@shard" not in owner:
            continue
        sid = owner.rsplit("@", 1)[1]
        if e.get("kind") == "stacked-aot":  # one coalesced device launch
            shard_launches[sid] = shard_launches.get(sid, 0) + 1
        elif e["name"] == "request":
            shard_requests[sid] = shard_requests.get(sid, 0) + 1
    failovers = [e for e in events if e["name"] == "failover"]
    if shard_launches or shard_requests or failovers:
        lines.append("")
        lines.append(f"fleet: {len(set(shard_launches) | set(shard_requests))} shards seen   failovers: {len(failovers)}")
        for sid in sorted(set(shard_launches) | set(shard_requests)):
            lines.append(
                f"  {sid:<10}launches: {shard_launches.get(sid, 0):>6}"
                f"   requests: {shard_requests.get(sid, 0):>6}"
            )
        for e in failovers:
            attrs = e.get("attrs") or {}
            lines.append(
                f"  failover shard {attrs.get('shard', '?')} -> peer {attrs.get('peer', '?')}"
                f"   epoch {attrs.get('epoch', '?')}   {float(attrs.get('ms', 0.0)):.1f} ms"
                f"   sessions {attrs.get('sessions', '?')}"
                f"   cause {attrs.get('cause', 'killed')}"
                + ("   standby" if attrs.get("standby") else "")
            )

    # cold start to first result: process start (trace window origin) to the
    # retirement of the first value-producing span — the number the
    # persistent cache exists to shrink
    first_result = [
        e for e in events if e["name"] in ("update", "forward", "compute")
    ]
    if first_result:
        first = min(first_result, key=lambda e: e.get("ts_us", 0.0))
        cold_us = first.get("ts_us", 0.0) + first.get("dur_us", 0.0) - span_start
        lines.append(f"cold start -> first result: {cold_us:.1f} us ({first['name']}:{first.get('kind', '?')})")
    return "\n".join(lines)


def run_instrumented_bench(path: str, device: str = "cuda") -> None:
    """Ten fused-collection forward steps and one compute under a single
    ``telemetry.instrument()`` block on ``device``, exported as JSONL to
    ``path`` and as a Chrome trace beside it (open the ``.trace.json`` in
    https://ui.perfetto.dev)."""
    import numpy as np
    import torch

    from metrics_tpu_torch import Accuracy, F1Score, MetricCollection, Precision, telemetry

    rng = np.random.RandomState(7)
    C = 16
    col = MetricCollection(
        {
            "acc": Accuracy(num_classes=C, average="macro", device=device),
            "f1": F1Score(num_classes=C, average="macro", device=device),
            "prec": Precision(num_classes=C, average="macro", device=device),
        },
        fused_update=True,
    )

    def batch(b):
        logits = rng.rand(b, C).astype(np.float32)
        return torch.from_numpy(logits).to(device), torch.from_numpy(rng.randint(0, C, b).astype(np.int32)).to(device)

    with telemetry.instrument() as session:
        for step in range(10):
            col(*batch(128 + step))  # ragged sizes inside one pow2 bucket
        vals = col.compute()
        float(vals["acc"])  # the value on the host: the run has finished
    session.export_jsonl(path)
    chrome_path = path.rsplit(".", 1)[0] + ".trace.json"
    session.export_chrome_trace(chrome_path)
    print(f"wrote {path} and {chrome_path} (Perfetto-loadable)", file=sys.stderr)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("trace", help="telemetry JSONL file to summarize (written first with --bench)")
    parser.add_argument(
        "--bench",
        action="store_true",
        help="run a short instrumented fused-collection eval and export it to TRACE first",
    )
    parser.add_argument("--device", default="cuda", help="where --bench runs (default: cuda)")
    args = parser.parse_args(argv)
    if args.bench:
        run_instrumented_bench(args.trace, args.device)
    print(summarize(load_events(args.trace)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
