#!/usr/bin/env python
"""Run the port's two-front static audit and check it against STATIC_AUDIT_TORCH.json.

Usage::

    python tools/torch_static_audit.py                   # summary of this run
    python tools/torch_static_audit.py --diff            # ratchet against the
        # checked-in baseline: exit 1 on NEW findings, on FIXED ones not yet
        # re-baselined, on a P0 with no `why`, or on a capstone drift
    python tools/torch_static_audit.py --json            # the full report
    python tools/torch_static_audit.py --write-baseline  # accept this run as
        # the new baseline (existing `why` annotations are carried forward)

The counterpart of ``tools/static_audit.py``. Everything is static: the
programs are traced on fake tensors (``FakeTensorMode``) and the sources are
walked with ``ast``, so it needs no CUDA device and runs in seconds on a CPU.
"""
import argparse
import json
import os
import sys
import time
from typing import Any, Dict

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def summarize(report: Dict[str, Any], elapsed_s: float) -> str:
    s = report["summary"]
    cap = report["capstone"]
    lines = [
        "== static audit ==",
        f"  swept {s['metrics_swept']} metrics ({s['device_traced']} device-traced,"
        f" {s['kernels_swept']} kernels) in {elapsed_s:.1f}s",
        f"  capstone (5-member classification suite): {cap['fused_collectives']} fused"
        f" collective / {cap['perleaf_collectives']} per-leaf, buckets {cap['buckets']}",
        f"  hazard table: {len(report['hazards'])} metrics with predicted rebuild hazards",
        "",
        "== findings ==",
    ]
    if not report["findings"]:
        lines.append("  none")
    by_code: Dict[str, int] = {}
    for f in report["findings"]:
        by_code[f["code"]] = by_code.get(f["code"], 0) + 1
    for code in sorted(by_code):
        sev = next(f["severity"] for f in report["findings"] if f["code"] == code)
        lines.append(f"  {code} ({sev}) x{by_code[code]}")
    for f in report["findings"]:
        if f["severity"] == "P0":
            lines.append(f"    {f['code']} {f['metric']} [{f['where']}]: {f['detail']}")
    return "\n".join(lines)


def summarize_diff(d: Dict[str, Any]) -> str:
    if d.get("error"):
        return f"FAIL: {d['error']}"
    lines = []
    if d["new"]:
        lines.append(f"FAIL: {len(d['new'])} NEW finding(s) not in the baseline (fix, or re-baseline with"
                     " --write-baseline):")
        lines.extend(f"  + {f['severity']} {f['code']} {f['metric']} [{f['where']}]: {f['detail']}" for f in d["new"])
    if d["fixed"]:
        lines.append(f"FAIL: {len(d['fixed'])} baselined finding(s) no longer occur: tighten the ratchet"
                     " (--write-baseline):")
        lines.extend(f"  - {f['severity']} {f['code']} {f['metric']} [{f['where']}]" for f in d["fixed"])
    if d["unexplained_p0"]:
        lines.append(f"FAIL: {len(d['unexplained_p0'])} P0 finding(s) without a `why` in the baseline:")
        lines.extend(f"  ? {f['code']} {f['metric']} [{f['where']}]: {f['detail']}" for f in d["unexplained_p0"])
    if d.get("capstone_drift"):
        lines.append(f"FAIL: capstone collective counts drifted: run={d['capstone_drift']['run']}"
                     f" baseline={d['capstone_drift']['baseline']}")
    if d["ok"]:
        lines.append("OK: audit matches baseline (no new findings, no stale entries, all P0s explained)")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--json", action="store_true", help="emit the full report as JSON")
    parser.add_argument("--diff", action="store_true", help="ratchet against the checked-in baseline; exit 1 on drift")
    parser.add_argument("--write-baseline", action="store_true", help="accept this run as the new baseline")
    parser.add_argument("--baseline", default=None, help="baseline path (default: STATIC_AUDIT_TORCH.json at the root)")
    args = parser.parse_args(argv)

    from metrics_tpu_torch.analysis import report as report_mod

    t0 = time.monotonic()
    report = report_mod.build_report()
    elapsed = time.monotonic() - t0

    if args.write_baseline:
        path = report_mod.write_baseline(report, args.baseline)
        print(f"wrote {path} ({len(report['findings'])} accepted findings)")
        return 0
    if args.diff:
        d = report_mod.diff(report, report_mod.load_baseline(args.baseline))
        print(summarize_diff(d))
        return 0 if d["ok"] else 1
    if args.json:
        json.dump(report, sys.stdout, indent=1)
        print()
        return 0
    print(summarize(report, elapsed))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
