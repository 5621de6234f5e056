"""The port's static audit (``metrics_tpu_torch/analysis``) and the read side
of its baseline, ``STATIC_AUDIT_TORCH.json``."""
import builtins
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from metrics_tpu_torch import Metric, forward_engine, telemetry
from metrics_tpu_torch.analysis import ast_lint, hazards, program_audit, registry, report

REPO = Path(__file__).resolve().parent.parent


class FlagSum(Metric):
    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(device="cpu", jit_update=True, **kwargs)
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, values, negate=False):
        self.total = self.total + (-1.0 if negate else 1.0) * torch.sum(values)

    def compute(self):
        return self.total


def test_hazards_read_the_ports_own_baseline_and_never_the_jax_packages(monkeypatch):
    monkeypatch.delenv("METRICS_TPU_STATIC_AUDIT", raising=False)
    opened = []
    real_open = builtins.open

    def spy(path, *args, **kwargs):
        opened.append(Path(path).resolve())
        return real_open(path, *args, **kwargs)

    monkeypatch.setattr(builtins, "open", spy)
    hazards.invalidate()
    try:
        assert Path(hazards.baseline_path()) == REPO / "STATIC_AUDIT_TORCH.json"
        hazards.predicted("Accuracy", "new-static-key")
    finally:
        hazards.invalidate()
    assert opened == [REPO / "STATIC_AUDIT_TORCH.json"]


def test_a_hazard_in_the_ports_baseline_reaches_a_compile_span(monkeypatch, tmp_path):
    """A table written into the port's baseline gives ``predicted=True`` on the
    engine's rebuild for a new static key; a JAX-package file beside it that
    predicts nothing is not read."""
    monkeypatch.delenv("METRICS_TPU_STATIC_AUDIT", raising=False)
    (tmp_path / "STATIC_AUDIT.json").write_text(json.dumps({"hazards": {}}))
    (tmp_path / hazards.BASELINE_NAME).write_text(
        json.dumps({"hazards": {"FlagSum": {"static-key": True, "signature": False}}}))
    monkeypatch.setattr(hazards, "_BASELINE_PATH", str(tmp_path / hazards.BASELINE_NAME))
    hazards.invalidate()
    try:
        metric = FlagSum()
        with telemetry.instrument() as session:
            metric.update(torch.ones(4))
            metric.update(torch.ones(4), negate=True)
        compiles = [e.attrs for e in session.events if e.name == "compile"]
    finally:
        hazards.invalidate()
    assert [(a["cause"], a.get("predicted")) for a in compiles] == [("first-compile", None), ("new-static-key", True)]
    assert float(metric.compute()) == 0.0


# ------------------------------------------------------------------ the audit against the JAX package's baseline
JAX_BASELINE = REPO / "STATIC_AUDIT.json"

# (metric, program) sites where the audits differ, as (the JAX rule, the port's rule, why). Under another rule:
# the JAX trace of `nonzero`/`unique`/`np.asarray` on a tracer fails with ConcretizationTypeError or
# TracerArrayConversionError (its JX301), the fake trace of the same op with DynamicOutputShapeException (JX401).
# Only in the port: a CUDA library call no graph can hold (program_audit.CUDA_UNCAPTURABLE_OPS), where XLA
# compiles the same solve into the program.
RULE_EXCEPTIONS = {
    ("SignalDistortionRatio", "pure_update"): (None, "JX301", "torch.linalg.solve_ex cannot be captured"),
    ("SignalDistortionRatio", "pure_forward"): (None, "JX301", "torch.linalg.solve_ex cannot be captured"),
    ("AUROC", "pure_compute"): ("JX301", "JX401", "nonzero over the distinct scores"),
    ("AveragePrecision", "pure_compute"): ("JX301", "JX401", "nonzero over the distinct scores"),
    ("PrecisionRecallCurve", "pure_compute"): ("JX301", "JX401", "nonzero over the distinct scores"),
    ("ROC", "pure_compute"): ("JX301", "JX401", "nonzero over the distinct scores"),
    **{(f"Retrieval{n}", "pure_compute"): ("JX301", "JX401", "grouping by the observed indexes")
       for n in ("FallOut", "HitRate", "MAP", "MRR", "NormalizedDCG", "Precision", "RPrecision", "Recall")},
}


@pytest.fixture(scope="module")
def audit():
    # the baseline's JX201 on PermutationInvariantTraining is the permutation table's first build: a test
    # that ran PIT earlier in this process would have cached it, so the sweep starts from a cold table
    from metrics_tpu_torch.functional.audio.pit import _permutation_table

    _permutation_table.cache_clear()
    return report.build_report()


@pytest.fixture(scope="module")
def jax_baseline():
    return json.loads(JAX_BASELINE.read_text())


def test_the_sweep_covers_the_jax_packages_metrics(audit, jax_baseline):
    assert audit["summary"]["metrics_swept"] == jax_baseline["summary"]["metrics_swept"] == 104
    assert audit["summary"]["device_traced"] == jax_baseline["summary"]["device_traced"] == 72
    assert audit["summary"]["kernels_swept"] == jax_baseline["summary"]["kernels_swept"] == 6
    scopes = {name: f["scope"] for name, f in audit["facts"].items()}
    assert scopes == {name: f["scope"] for name, f in jax_baseline["facts"].items()}
    assert not [f for f in audit["findings"] if f["code"] == "JX000"]


def _sync_sites(findings, codes=("JX301", "JX401")):
    return {(f["metric"], f["where"]): f["code"] for f in findings if f["code"] in codes}


def test_host_syncs_and_dynamic_shapes_are_found_where_jax_finds_them(audit, jax_baseline):
    port, jax = _sync_sites(audit["findings"]), _sync_sites(jax_baseline["findings"])
    differ = {site: (jax.get(site), port.get(site)) for site in set(port) | set(jax) if port.get(site) != jax.get(site)}
    assert differ == {site: rule[:2] for site, rule in RULE_EXCEPTIONS.items()}


def test_the_capstone_equals_the_jax_baseline(audit, jax_baseline):
    assert audit["capstone"] == jax_baseline["capstone"] == {
        "fused_collectives": 1, "perleaf_collectives": 17, "buckets": {"int32:sum": 17}, "sharded_buckets": 0}


def test_no_rule_without_a_torch_meaning_is_emitted(audit):
    """JX102 (weak types) and JX103 (x64 widening) have no torch meaning, nor
    MT401 (host callbacks): the JAX package's 42 JX103s have no counterpart."""
    assert not {f["code"] for f in audit["findings"]} & {"JX102", "JX103", "MT401"}
    assert "MT401" not in ast_lint.SEVERITY
    for text in ("JX102", "JX103"):
        assert text in program_audit.__doc__
    assert "MT401" in ast_lint.__doc__


def test_the_kernel_cases_trace_each_wrapper_through_its_plain_version(audit):
    kernels = {name: f for name, f in audit["facts"].items() if f["scope"] == "kernel"}
    assert set(kernels) == {"ops.binned_stats", "ops.confusion_matrix", "ops.countmin_scatter",
                            "ops.retrieval_sort", "ops.stat_scores", "ops.window_tick"}
    for name, facts in kernels.items():
        for prog, pf in facts["programs"].items():
            assert pf["error"] is None and pf["kernel_routes"] >= 1, (name, prog)
    assert set(kernels["ops.stat_scores"]["programs"]) == set(kernels["ops.countmin_scatter"]["programs"]) == {
        "plain", "sessions"}


def test_a_fake_cuda_tensor_never_reaches_a_kernel():
    from metrics_tpu_torch import ops

    with program_audit.fake_mode():
        t = torch.zeros(16, dtype=torch.int32, device="cuda")
        with program_audit._spies(), pytest.raises(RuntimeError, match="fake CUDA tensor"):
            ops.stat_scores_counts(t, t, t == t, t, 4)


def test_the_committed_baseline_holds_and_explains_every_p0(audit, jax_baseline):
    baseline = report.load_baseline()
    assert baseline is not None and os.path.basename(hazards.baseline_path()) == "STATIC_AUDIT_TORCH.json"
    d = report.diff(audit, baseline)
    assert d["ok"], d
    assert all(f["why"] for f in baseline["findings"] if f["severity"] == "P0")
    assert baseline["hazards"] == audit["hazards"] == jax_baseline["hazards"] == {}


def test_the_lint_leaves_no_unexplained_p0_over_the_port():
    """The port's guard and metadata reads are known to the lint: of the
    JAX lint's 13 findings over the port, one is left (``float()`` of a
    Python number), and the baseline explains it."""
    violations = ast_lint.lint_paths()
    assert [(v.code, v.path, v.qualname) for v in violations] == [
        ("MT101", "metrics_tpu_torch/streaming/sketch.py", "CountMinHeavyHitters.update")]
    whys = {f["key"]: f["why"] for f in report.load_baseline()["findings"]}
    assert all(whys.get(v.key) for v in violations)


_PLANTED = textwrap.dedent('''
    import torch
    from metrics_tpu_torch import Metric


    class PlantedSync(Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

        def update(self, x):
            self.total = self.total + x.sum().item()

        def compute(self):
            return self.total


    class PlantedShape(Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

        def update(self, x):
            self.total = self.total + torch.nonzero(x > 0.5).shape[0]

        def compute(self):
            return self.total
''')


def test_planted_metrics_give_mt101_jx301_and_jx401():
    violations = ast_lint.lint_source(_PLANTED, "planted.py")
    assert [(v.code, v.qualname) for v in violations] == [("MT101", "PlantedSync.update")]
    namespace = {}
    exec(compile(_PLANTED, "planted.py", "exec"), namespace)
    args = lambda pools: (pools["reg_p"],)  # noqa: E731
    cases = [registry.AuditCase(name, "device", lambda d, c=namespace[name]: c(device=d), args)
             for name in ("PlantedSync", "PlantedShape")]
    facts, findings = program_audit.run_audit(cases)
    assert {f.key for f in findings} == {"JX301:PlantedSync:pure_update", "JX401:PlantedShape:pure_update"}
    assert facts["PlantedSync"]["hazards"]["signature"] and "forward" not in facts["PlantedSync"]["programs"]


def test_a_collective_and_a_host_copy_in_a_pure_path_are_found():
    import torch.distributed as dist

    class Gathers(Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

        def update(self, x):
            dist.all_reduce(x)
            self.total = self.total + x.sum()

        def compute(self):
            return self.total.cpu()

    case = registry.AuditCase("Gathers", "device", lambda d: Gathers(device=d), lambda pools: (pools["reg_p"],))
    _, findings = program_audit.run_audit([case])
    assert {(f.code, f.severity, f.where) for f in findings} == {("JX501", "P1", "pure_update"),
                                                                  ("JX201", "P0", "pure_compute")}


def test_a_tensor_made_from_host_data_on_the_device_is_a_host_copy():
    """``torch.tensor(n, device=...)`` in an update is a host-to-device copy
    on the card (a sync); ``torch.full`` on the device and a CPU constant
    are not."""
    class Counts(Metric):
        def __init__(self, copy, **kwargs):
            super().__init__(**kwargs)
            self.copy = copy
            self.add_state("total", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

        def update(self, x):
            if self.copy:
                n = torch.tensor(x.shape[0], dtype=torch.int32, device=x.device)
            else:
                n = torch.full((), x.shape[0], dtype=torch.int32, device=x.device) + torch.tensor(0, dtype=torch.int32)
            self.total = self.total + n

        def compute(self):
            return self.total

    args = lambda pools: (pools["reg_p"],)  # noqa: E731
    cases = [registry.AuditCase(f"Counts{copy}", "device", lambda d, c=copy: Counts(c, device=d), args)
             for copy in (True, False)]
    _, findings = program_audit.run_audit(cases)
    assert {f.key for f in findings} == {"JX201:CountsTrue:pure_update", "JX201:CountsTrue:pure_forward"}


def test_a_state_whose_dtype_the_update_changes_is_jx101():
    class Widens(Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("total", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

        def update(self, x):
            self.total = self.total + x.sum()

        def compute(self):
            return self.total

    case = registry.AuditCase("Widens", "device", lambda d: Widens(device=d), lambda pools: (pools["reg_p"],))
    facts, findings = program_audit.run_audit([case])
    assert [f.key for f in findings] == ["JX101:Widens:total"]
    assert facts["Widens"]["hazards"] == {"static-key": False, "signature": True}


def test_the_ratchet_round_trips(audit, tmp_path):
    path = str(tmp_path / "audit.json")
    report.write_baseline(audit, path)
    try:
        baseline = report.load_baseline(path)
        assert report.diff(audit, baseline)["ok"]
        fewer = dict(audit, findings=audit["findings"][1:])
        d = report.diff(fewer, baseline)
        assert not d["ok"] and [f["key"] for f in d["fixed"]] == [audit["findings"][0]["key"]]
        planted = {"key": "JX301:X:pure_update", "code": "JX301", "severity": "P0", "metric": "X",
                   "where": "pure_update", "detail": "planted"}
        d = report.diff(dict(audit, findings=audit["findings"] + [planted]), baseline)
        assert not d["ok"] and [f["key"] for f in d["new"]] == [planted["key"]]
        assert [f["key"] for f in d["unexplained_p0"]] == [planted["key"]]
        drifted = dict(audit, capstone=dict(audit["capstone"], fused_collectives=2))
        assert report.diff(drifted, baseline)["capstone_drift"] is not None
        # a rewrite keeps each finding's why
        baseline["findings"][0]["why"] = "kept"
        Path(path).write_text(json.dumps(baseline))
        report.write_baseline(audit, path)
        assert report.load_baseline(path)["findings"][0]["why"] == "kept"
    finally:
        hazards.invalidate()


def test_the_forward_program_audited_is_the_engines():
    """The forward program the audit traces, run on real CPU tensors, gives
    the state and batch value the engine's ``forward`` gives."""
    from metrics_tpu_torch import Accuracy

    pools = registry.example_inputs()
    metric = Accuracy(num_classes=4, average="macro", device="cpu", jit_update=True)
    metric.update(pools["probs"], pools["labels"])
    names, fn = forward_engine.audit_forward_program(metric)
    leaves = tuple(getattr(metric, n).clone() for n in names)
    new_leaves, value = fn(torch.tensor(2.0), leaves, pools["probs"], pools["labels"])
    engine_value = metric(pools["probs"], pools["labels"])
    assert metric.forward_stats["launches"] == 1
    assert torch.equal(value, engine_value)
    assert all(torch.equal(a, getattr(metric, n)) for a, n in zip(new_leaves, names))


def test_the_cli_diff_exits_0_on_this_tree(audit, monkeypatch, capsys):
    """``tools/torch_static_audit.py --diff`` on this tree (no card here),
    given the report the module's sweep made."""
    import runpy

    cli = runpy.run_path(str(REPO / "tools" / "torch_static_audit.py"), run_name="cli")
    monkeypatch.setattr(report, "build_report", lambda: audit)
    assert cli["main"](["--diff"]) == 0
    assert capsys.readouterr().out.startswith("OK: audit matches baseline")


def test_analysis_loads_its_seven_submodules_lazily():
    from metrics_tpu_torch import analysis  # noqa: F811 -- the package, not a submodule

    assert sorted(analysis.__all__) == ["ast_lint", "billing", "cost_model", "hazards", "program_audit", "registry",
                                        "report"]
    code = ("import sys, metrics_tpu_torch.analysis as a\n"
            "print(sorted(m for m in sys.modules if m.startswith('metrics_tpu_torch.analysis.')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=120)
    loaded = eval(proc.stdout.strip().splitlines()[-1])
    assert not {f"metrics_tpu_torch.analysis.{m}" for m in ("ast_lint", "program_audit", "registry", "report")} \
        & set(loaded)
    with pytest.raises(AttributeError, match="program_audit"):
        analysis.jaxpr_audit
