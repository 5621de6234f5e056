"""What the harness loads: never JAX, Flax or the JAX package, and never the JAX package's own
benchmark records; and no result without a card."""
import ast
import os
import subprocess
import sys
from pathlib import Path

from portbench.tests.tiny import REPO

PORTBENCH = REPO / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "metrics_tpu"}


def _sources():
    return sorted(p for p in PORTBENCH.rglob("*.py") if "tests" not in p.relative_to(PORTBENCH).parts)


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_source_of_the_harness_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = {name.split(".")[0] for name in _imported(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_no_source_of_the_harness_reads_the_jax_package_benchmark_records():
    names = ("bench" + ".py", "chip_smoke", "BENCH" + "_", "BASELINE", "MULTICHIP", "TPU_CAPTURES")
    for path in sorted(PORTBENCH.rglob("*")):
        if path.is_file() and path.suffix in (".py", ".json") and path.name != Path(__file__).name:
            text = path.read_text()
            assert not [n for n in names if n in text], path


_RUN_TINY = """
import sys, time
from pathlib import Path
sys.path.insert(0, {repo!r})
import torch
from portbench import harness
from portbench.tests.tiny import make_root
root = make_root(Path({tmp!r}))
for cell in ("tiny.logits", "tiny.labels"):
    result = harness.run(root, cell, 2**31 + 3, 0.1, False, torch.device("cpu"), time.time(), log=lambda m: None)
    assert result["correct"], result
print(",".join(harness.forbidden_modules()) or "none")
"""


def test_a_run_loads_no_forbidden_module(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _RUN_TINY.format(repo=str(REPO), tmp=str(tmp_path))],
                         capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "none"


def test_without_a_card_the_run_exits_nonzero_and_prints_no_result():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(PORTBENCH / "run.py"), "--workload", "cityscapes_val_seg.eval_logits",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True, env=env,
                         timeout=300, cwd=REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr


def test_in_a_directory_of_only_the_benchmark_files_the_run_fails(tmp_path):
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PORTBENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(tmp_path / "portbench" / "run.py"), "--workload",
                          "cityscapes_val_seg.eval_labels", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
