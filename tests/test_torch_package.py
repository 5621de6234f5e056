"""Guards on the port's boundary: it imports neither JAX nor the JAX package
(nor do its tools, ``tools/torch_*.py``), and ``chip_smoke.py`` fails (and
claims nothing) where there is no card."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "metrics_tpu_torch"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even where there is one
    return env


def test_import_leaves_jax_and_the_jax_package_out():
    code = (
        "import sys, runpy, metrics_tpu_torch, metrics_tpu_torch.interop, metrics_tpu_torch.parallel,"
        " metrics_tpu_torch.quant, metrics_tpu_torch.sync_engine, metrics_tpu_torch.fabric, metrics_tpu_torch.serve,"
        " metrics_tpu_torch.audio, metrics_tpu_torch.functional.audio, metrics_tpu_torch.functional.audio._pesq_core\n"
        "for tool in ('tools/torch_wal_scrub.py', 'tools/torch_loadgen.py'):\n"
        "    runpy.run_path(tool, run_name='tool')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'metrics_tpu' or m.startswith('metrics_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + sorted((REPO / "tools").glob("torch_*.py"))
                         + [REPO / "chip_smoke.py"], ids=lambda p: p.name)
def test_no_jax_import_in_the_port(path):
    for name in _imported_modules(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "metrics_tpu"), f"{path.relative_to(REPO)} imports {name}"


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_without_the_package(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    env = _env()
    env["PYTHONPATH"] = ""
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
