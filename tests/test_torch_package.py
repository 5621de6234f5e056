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
        " metrics_tpu_torch.audio, metrics_tpu_torch.functional.audio, metrics_tpu_torch.functional.audio._pesq_core,"
        " metrics_tpu_torch.native, metrics_tpu_torch.text, metrics_tpu_torch.functional.text,"
        " metrics_tpu_torch.functional.text.rouge, metrics_tpu_torch.functional.text.sentence_split,"
        " metrics_tpu_torch.functional.text.squad, metrics_tpu_torch.functional.text.bert, metrics_tpu_torch.detection,"
        " metrics_tpu_torch.image.inception_net, metrics_tpu_torch.image.lpips_net, metrics_tpu_torch.image.fid,"
        " metrics_tpu_torch.image.kid, metrics_tpu_torch.image.inception, metrics_tpu_torch.image.lpip,"
        " metrics_tpu_torch.utilities.jax_random\n"
        "for tool in ('tools/torch_wal_scrub.py', 'tools/torch_loadgen.py'):\n"
        "    runpy.run_path(tool, run_name='tool')\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax') or m.startswith(('jax.', 'jaxlib', 'flax.'))"
        " or m == 'metrics_tpu' or m.startswith('metrics_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_text_core_builds_the_ports_own_source(tmp_path, monkeypatch):
    """The edit-distance core's loader compiles ``metrics_tpu_torch/native/edit_distance.cpp``
    into the port's build directory, and reads nothing under ``metrics_tpu/``."""
    from metrics_tpu_torch import native

    commands = []
    run = subprocess.run

    def spy(cmd, *args, **kwargs):
        commands.append([str(part) for part in cmd])
        return run(cmd, *args, **kwargs)

    monkeypatch.setattr(native.subprocess, "run", spy)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    native.load()
    assert len(commands) == 1
    source = str(PACKAGE / "native" / "edit_distance.cpp")
    assert commands[0][-1] == source and commands[0][1:-3] == list(native.CXX_FLAGS)
    jax_package = str(REPO / "metrics_tpu") + os.sep
    assert not any(part.startswith(jax_package) for part in commands[0])
    assert native.library_path().parent == tmp_path / "_build" and native.library_path().exists()
    assert native.levenshtein_ids([1, 2, 3], [1, 3]) == 1


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
        assert root not in ("jax", "jaxlib", "flax", "metrics_tpu"), f"{path.relative_to(REPO)} imports {name}"


_NETS = ("image/inception_net.py", "image/lpips_net.py", "image/fid.py", "image/kid.py", "image/inception.py",
         "image/lpip.py", "utilities/jax_random.py")


def test_the_scan_covers_the_nets_and_their_draws():
    """The import scan above runs over the six modules of the nets and
    ``utilities/jax_random.py``: they are in the package and parametrised."""
    scanned = {p.relative_to(PACKAGE).as_posix() for p in PACKAGE.rglob("*.py")}
    assert set(_NETS) <= scanned


def test_exports_equal_the_jax_packages():
    """Nothing of the JAX package's top-level ``__all__`` is missing, and
    ``image`` exports the JAX package's names (the nets' classes included)."""
    import metrics_tpu as J
    import metrics_tpu.image as jax_image
    import metrics_tpu_torch as M
    import metrics_tpu_torch.image as image

    assert set(J.__all__) - set(M.__all__) == set()

    def names(module):
        return {n for n, v in vars(module).items() if not n.startswith("_") and isinstance(v, type)}

    assert names(image) == names(jax_image)
    assert {"InceptionV3", "InceptionV3FeatureExtractor"} <= names(image)


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
