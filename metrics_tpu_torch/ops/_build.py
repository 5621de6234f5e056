"""Build the CUDA sources under ``metrics_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library, which the op modules call through ``ctypes``
(every pointer and the stream as ``c_void_p``). A library is built at first
use and cached under ``metrics_tpu_torch/_build/`` by a hash of the sources
and flags; :func:`build` starts one ``nvcc`` per missing library, all at
once. A missing ``nvcc`` or a failed build raises.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"
SOURCES = ("stat_scores", "confusion", "binned_stats", "retrieval_sort", "countmin")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc was not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); cannot build the CUDA kernels")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every library of ``names`` that is not built yet, in parallel."""
    targets = {name: library_path(name) for name in names}
    missing = {name: path for name, path in targets.items() if not path.exists()}
    if not missing:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    for name, path in missing.items():
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{output}")
            tmp.unlink(missing_ok=True)
        else:
            # a finished library appears under its final name in one step
            os.replace(tmp, missing[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if needed (the op
    modules keep the loaded handle)."""
    return ctypes.CDLL(str(build([name])[name]))
