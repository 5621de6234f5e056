"""Guards on the port's boundary: it imports neither JAX nor the JAX package
(nor do its tools, ``tools/torch_*.py``), and ``chip_smoke.py`` fails (and
claims nothing) where there is no card."""
import ast
import json
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
        " metrics_tpu_torch.utilities.jax_random, metrics_tpu_torch.__about__, metrics_tpu_torch.analysis.program_audit,"
        " metrics_tpu_torch.analysis.ast_lint, metrics_tpu_torch.analysis.registry, metrics_tpu_torch.analysis.report\n"
        "for tool in ('tools/torch_wal_scrub.py', 'tools/torch_loadgen.py', 'tools/torch_static_audit.py',"
        " 'tools/torch_trace_report.py', 'tools/torch_convert_inception_weights.py',"
        " 'tools/torch_convert_lpips_weights.py'):\n"
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


_FLAX_ONLY = "a flax module or helper of the JAX net; the port's net is one torch.nn.Module with the same parameters"
_NO_SWITCH = "the JAX registry's Pallas opt-in switch: in the port the tensor's device decides, with no switch"
# every JAX sub-module's public name without a counterpart of the same name in the port, with the reason
NAME_DIFFERENCES = {
    ("metrics_tpu.ops", "pallas_enabled"): _NO_SWITCH,
    ("metrics_tpu.ops", "refresh"): _NO_SWITCH,
    ("metrics_tpu.ops.registry", "pallas_enabled"): _NO_SWITCH,
    ("metrics_tpu.ops.registry", "refresh"): _NO_SWITCH,
    ("metrics_tpu.ops.registry", "resolve"): _NO_SWITCH,
    ("metrics_tpu.ops.registry", "launch"): "a guarded launch that demotes to the lax path: the port has no"
                                            " fallback, a failed launch raises",
    ("metrics_tpu.parallel.dist_env", "AxisEnv"): "collectives over a shard_map mesh axis: PyTorch has no SPMD"
                                                  " trace, a mesh axis becomes a process group (ProcessEnv)",
    ("metrics_tpu.functional.text.bert", "transformers_flax_embedder"): "a Flax model's embedder; its counterpart"
                                                                        " is transformers_embedder",
    ("metrics_tpu.image.inception_net", "BasicConv"): _FLAX_ONLY,
    ("metrics_tpu.image.inception_net", "cached_random_init"): "caches flax's eager init; the port seeds its"
                                                               " default weights (seeded_init_)",
    ("metrics_tpu.image.lpips_net", "AlexNetFeatures"): _FLAX_ONLY,
    ("metrics_tpu.image.lpips_net", "SqueezeNetFeatures"): _FLAX_ONLY,
    ("metrics_tpu.image.lpips_net", "VGG16Features"): _FLAX_ONLY,
    ("metrics_tpu.functional.image.ssim", "np_prod"): "a Python product of the kernel size; the port uses"
                                                      " math.prod",
    ("metrics_tpu.analysis", "jaxpr_audit"): "renamed: its counterpart is analysis.program_audit",
    ("metrics_tpu.analysis.ast_lint", "CALLBACK_NAMES"): "MT401's host callbacks, a rule with no torch meaning",
}
# JAX sub-modules with no port module of the same name
MODULE_DIFFERENCES = {
    "metrics_tpu.aot_cache": "persists XLA executables; the port's one compile, nvcc's, persists in ops/_build.py"
                             " by a digest of sources and flags, and a CUDA graph cannot be serialized across"
                             " processes",
    "metrics_tpu._compat": "jax-version shims (shard_map, axis_size, enable_x64); profiler_annotation's"
                           " counterpart is telemetry.profiler_range",
    "metrics_tpu.analysis.jaxpr_audit": "renamed: metrics_tpu_torch.analysis.program_audit",
}
# rules of the JAX audit with no torch meaning (pinned in tests/test_torch_static_audit.py)
RULE_DIFFERENCES = {
    "JX102": "a weak-typed state default: a torch tensor has no weak type",
    "JX103": "a state that widens under x64: no global switch widens a torch dtype",
    "MT401": "a host callback in a pure path: no callback primitive exists inside a torch program",
}


def _public_names(module):
    """``__all__``, else the names the module itself defines (and upper-case constants)."""
    if hasattr(module, "__all__"):
        return set(module.__all__)
    import inspect

    return {n for n, v in vars(module).items() if not n.startswith("_") and not inspect.ismodule(v)
            and (getattr(v, "__module__", None) == module.__name__ or (n.isupper() and not callable(v)))}


def _jax_submodules():
    import pkgutil

    import metrics_tpu

    return sorted(info.name for info in pkgutil.walk_packages(metrics_tpu.__path__, "metrics_tpu."))


@pytest.mark.parametrize("name", _jax_submodules())
def test_every_jax_submodule_has_its_counterpart(name):
    """Each public name of each JAX sub-module has a counterpart of the same
    name in the port, or a pinned, reasoned difference."""
    import importlib

    jax_module = importlib.import_module(name)
    if name in MODULE_DIFFERENCES:
        assert MODULE_DIFFERENCES[name]
        return
    port = importlib.import_module("metrics_tpu_torch" + name[len("metrics_tpu"):])
    missing = {n for n in _public_names(jax_module) if not hasattr(port, n)}
    pinned = {n for (m, n) in NAME_DIFFERENCES if m == name}
    assert missing == pinned
    assert all(hasattr(jax_module, n) for n in pinned)


def test_the_pinned_differences_are_all_used_and_the_version_is_pyprojects():
    import tomllib

    import metrics_tpu_torch as M
    from metrics_tpu_torch.analysis import ast_lint, program_audit

    modules = set(_jax_submodules())
    assert {m for m, _ in NAME_DIFFERENCES} <= modules and set(MODULE_DIFFERENCES) <= modules
    assert M.__version__ == "0.1.0" == tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["version"]
    assert "MT401" not in ast_lint.SEVERITY
    assert all(code in (program_audit.__doc__ + ast_lint.__doc__) for code in RULE_DIFFERENCES)


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


def test_the_package_data_ships_the_ports_sources():
    """setuptools' package-data resolution for the port's packages, read from
    ``pyproject.toml`` without building: the kernels' CUDA sources and the
    text core's C++ source (which ``native.load()`` compiles) are shipped."""
    code = (
        "import json, warnings\n"
        "warnings.simplefilter('ignore')\n"
        "from setuptools.dist import Distribution\n"
        "from setuptools.config.pyprojecttoml import apply_configuration\n"
        "dist = Distribution()\n"
        "apply_configuration(dist, 'pyproject.toml')\n"
        "dist.include_package_data = False\n"
        "cmd = dist.get_command_obj('build_py')\n"
        "cmd.ensure_finalized()\n"
        "cmd.manifest_files = {}\n"
        "print(json.dumps({p: cmd.find_data_files(p, cmd.get_package_dir(p)) for p in dist.packages"
        " if p.startswith('metrics_tpu_torch')}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    shipped = {f for files in json.loads(proc.stdout.splitlines()[-1]).values() for f in files}
    assert "metrics_tpu_torch/native/edit_distance.cpp" in shipped
    sources = {p.relative_to(REPO).as_posix() for p in (PACKAGE / "csrc").iterdir() if p.suffix in (".cu", ".cuh")}
    assert sources and sources <= shipped
