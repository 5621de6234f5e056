"""Merge both audit fronts into the checked-in ``STATIC_AUDIT_TORCH.json``.

Port of ``metrics_tpu/analysis/report.py``. The baseline is a *ratchet*:
the findings present when it was written are the accepted set, each with a
``why`` that explains the acceptance. :func:`diff` fails on **new**
findings (regressions), on **fixed** ones (re-baseline, so the ratchet
tightens), on a P0 with no ``why`` and on a drift of the capstone, the
classification suite's static collective plan.

The file also carries the per-metric facts (states, the programs' operation
counts, sync buckets) and the hazard table that
:mod:`metrics_tpu_torch.analysis.hazards` serves to the engines' compile
spans. It is the port's own file: the JAX package's ``STATIC_AUDIT.json``
describes the JAX programs and is never written or read here.
"""
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from metrics_tpu_torch.analysis import ast_lint, hazards, program_audit

VERSION = 1

# Standing explanations stamped onto known-accepted finding classes when a
# baseline is (re)written, so that regeneration never loses the rationale.
# First match wins; the third element matches the finding's metric (None: any).
_CURVE_METRICS = {"ROC", "PrecisionRecallCurve", "AUROC", "AveragePrecision"}
DEFAULT_EXPLANATIONS: List[Tuple[str, Optional[set], str]] = [
    (
        "JX401",
        _CURVE_METRICS,
        "curve compute thresholds on the observed score values (nonzero on the distinct scores); list-state"
        " metrics never enter the engines, so compute is eager by design and its host reads are not on a hot"
        " path (the JAX package's JX301 on the same computes)",
    ),
    (
        "JX401",
        None,  # the other JX401s are the retrieval computes
        "retrieval compute groups by the observed `indexes` (unique over a dynamic group count); list-state,"
        " eager by design (the JAX package's JX301 on the same computes)",
    ),
    (
        "JX301",
        {"SignalDistortionRatio"},
        "SDR's Toeplitz systems are solved by torch.linalg.solve_ex, cuSOLVER's batched LU, which invalidates a"
        " CUDA graph capture: the engines demote SDR to its eager update (chip_smoke.py slice 17); a Levinson"
        " solve that a graph can hold is untried (ROADMAP.md)",
    ),
    (
        "JX201",
        {"PermutationInvariantTraining"},
        "the permutation table is built once a speaker count and device (functools.lru_cache in"
        " functional/audio/pit.py): one host-to-device copy at its first use, none in a warm or captured update",
    ),
    (
        "MT101",
        None,
        "float() of a Python number: the else branch of isinstance(weight, Tensor); a tensor weight stays on"
        " the device, and the lint cannot see the narrowing",
    ),
]


def build_report() -> Dict[str, Any]:
    """Run both fronts and the capstone; return the merged report."""
    facts, program_findings = program_audit.run_audit()
    findings: List[Dict[str, Any]] = [
        {"key": f.key, "code": f.code, "severity": f.severity, "metric": f.metric, "where": f.where,
         "detail": f.detail}
        for f in program_findings
    ]
    findings.extend(
        {"key": v.key, "code": v.code, "severity": v.severity, "metric": v.qualname,
         "where": f"{v.path}:{v.lineno}", "detail": v.detail}
        for v in ast_lint.lint_paths()
    )
    findings.sort(key=lambda d: (d["severity"], d["key"]))
    counts: Dict[str, int] = {}
    for d in findings:
        counts[d["severity"]] = counts.get(d["severity"], 0) + 1
    return {
        "version": VERSION,
        "summary": {
            "metrics_swept": len(facts),
            "device_traced": sum(1 for v in facts.values() if v.get("scope") == "device"),
            "kernels_swept": sum(1 for v in facts.values() if v.get("scope") == "kernel"),
            "findings": counts,
        },
        "capstone": program_audit.classification_suite_sync_plan(),
        "hazards": {
            name: v["hazards"] for name, v in sorted(facts.items()) if any(v.get("hazards", {}).values())
        },
        "findings": findings,
        "facts": {name: facts[name] for name in sorted(facts)},
    }


def _explain(finding: Dict[str, Any], previous: Dict[str, str]) -> str:
    """Carry an existing ``why`` forward, else stamp the standing one."""
    prev = previous.get(finding["key"], "")
    if prev:
        return prev
    for code, metrics, why in DEFAULT_EXPLANATIONS:
        if finding["code"] == code and (metrics is None or finding["metric"] in metrics):
            return why
    return ""


def load_baseline(path: Optional[str] = None) -> Optional[Dict[str, Any]]:
    path = path or hazards.baseline_path()
    if not os.path.exists(path):
        return None
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh)


def write_baseline(report: Dict[str, Any], path: Optional[str] = None) -> str:
    """Persist ``report`` as the new accepted baseline (the ratchet reset)."""
    path = path or hazards.baseline_path()
    old = load_baseline(path)
    previous = {f["key"]: f.get("why", "") for f in old.get("findings", [])} if old else {}
    out = dict(report)
    out["findings"] = [{**f, "why": _explain(f, previous)} for f in report["findings"]]
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(out, fh, indent=1, sort_keys=False)
        fh.write("\n")
    hazards.invalidate()
    return path


def unexplained_p0(report: Dict[str, Any], baseline: Optional[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """P0 findings with no ``why`` in the baseline: the acceptance gate."""
    whys = {f["key"]: f.get("why", "") for f in (baseline or {}).get("findings", [])}
    return [f for f in report["findings"] if f["severity"] == "P0" and not whys.get(f["key"], "")]


def diff(report: Dict[str, Any], baseline: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Ratchet comparison: new findings fail, fixed findings ask for a
    re-baseline, a capstone drift fails outright."""
    if baseline is None:
        return {
            "ok": False,
            "error": f"no baseline at {hazards.baseline_path()}: run tools/torch_static_audit.py --write-baseline",
            "new": report["findings"], "fixed": [], "unexplained_p0": [],
        }
    base_keys = {f["key"]: f for f in baseline.get("findings", [])}
    run_keys = {f["key"]: f for f in report["findings"]}
    new = [f for k, f in sorted(run_keys.items()) if k not in base_keys]
    fixed = [f for k, f in sorted(base_keys.items()) if k not in run_keys]
    missing_why = unexplained_p0(report, baseline)
    capstone_drift = report["capstone"] != baseline.get("capstone")
    return {
        "ok": not new and not fixed and not missing_why and not capstone_drift,
        "new": new,
        "fixed": fixed,
        "unexplained_p0": missing_why,
        "capstone_drift": (
            {"run": report["capstone"], "baseline": baseline.get("capstone")} if capstone_drift else None
        ),
    }
