"""The edit-distance core of the text metrics: host C++ behind ``ctypes``.

``edit_distance.cpp`` is the JAX package's native core, copied whole: the
Levenshtein dynamic program (one pair, or a batch of pairs in one call), the
n-gram multiset overlap of chrF, the longest common subsequence and its
covered positions (ROUGE-L), Extended Edit Distance's grid, and COCO's
greedy box matching. Tokens are mapped to int32 ids in Python, so strings
never cross the boundary.

The library is built at first use with ``g++ -O3 -shared -fPIC`` into
``metrics_tpu_torch/_build/``, named by a hash of the source and flags. A
build writes a temporary file and renames it, so processes that reach their
first call together converge on one library; a lock keeps the threads of a
process from building at once. There is no switch that turns the core off
and no fallback: a missing ``g++`` or a failed build raises, with the
compiler's output. The plain versions the core is held against live beside
their callers (``functional/text/helper.py``'s two-row DP, the numpy grid of
``functional/text/eed.py``, chrF's ``Counter`` path).
"""
import ctypes
import hashlib
import itertools
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "edit_distance.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
# one build at a time in a process; other processes race safely through the atomic rename
_LOCK = threading.Lock()
_lib = None

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(_SRC.read_bytes())
    return BUILD_DIR / f"libeditdist-{digest.hexdigest()[:16]}.so"


def _compile(path: Path) -> None:
    compiler = shutil.which("g++")
    if compiler is None:
        raise RuntimeError(f"g++ was not found on PATH; cannot build the edit-distance core ({_SRC})")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([compiler, *CXX_FLAGS, "-o", tmp, str(_SRC)], capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {_SRC.name} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)  # the finished library appears under its final name in one step
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _declare(lib: ctypes.CDLL) -> None:
    lib.tm_levenshtein.restype = ctypes.c_int64
    lib.tm_levenshtein.argtypes = [_I32P, ctypes.c_int64, _I32P, ctypes.c_int64]
    lib.tm_levenshtein_batch.restype = None
    lib.tm_levenshtein_batch.argtypes = [_I32P, _I64P, _I32P, _I64P, ctypes.c_int64, _I64P]
    lib.tm_coco_match.restype = None
    lib.tm_coco_match.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    lib.tm_eed.restype = ctypes.c_double
    lib.tm_eed.argtypes = [_I32P, ctypes.c_int64, _I32P, ctypes.c_int64, ctypes.c_int32,
                           ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double]
    # void* arguments: the raw ``.ctypes.data`` integer passes without a cast object a call. These run once a
    # sentence pair on the chrF and ROUGE paths, and COCO's matching once an (image, class, area), where that cost
    # rivals the C work
    lib.tm_ngram_overlap.restype = None
    lib.tm_ngram_overlap.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_int32, ctypes.c_void_p]
    lib.tm_lcs.restype = ctypes.c_int64
    lib.tm_lcs.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    lib.tm_lcs_union_mark.restype = None
    lib.tm_lcs_union_mark.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_void_p]


def load() -> ctypes.CDLL:
    """The loaded library, built first where it is missing."""
    global _lib
    if _lib is None:
        with _LOCK:
            if _lib is None:
                path = library_path()
                if not path.exists():
                    _compile(path)
                lib = ctypes.CDLL(str(path))
                _declare(lib)
                _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the core loads (built first where it is missing). A False
    here is no fallback: every entry point raises the build's error."""
    try:
        load()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


def _as_i32(x: Sequence) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.int32)


def levenshtein_ids(a: Sequence, b: Sequence) -> int:
    """Edit distance between two int32 id sequences."""
    lib = load()
    a, b = _as_i32(a), _as_i32(b)
    return int(lib.tm_levenshtein(a.ctypes.data_as(_I32P), len(a), b.ctypes.data_as(_I32P), len(b)))


def levenshtein_batch_ids(a_seqs: Sequence[Sequence], b_seqs: Sequence[Sequence]) -> np.ndarray:
    """Edit distances of ``len(a_seqs)`` id-sequence pairs (lists or arrays) in one call, as int64."""
    if len(a_seqs) != len(b_seqs):
        raise ValueError(f"expected as many second sequences as first ones, got {len(b_seqs)} and {len(a_seqs)}")
    lib = load()
    (a_flat, a_off), (b_flat, b_off) = _flatten(a_seqs), _flatten(b_seqs)
    out = np.empty(len(a_seqs), dtype=np.int64)
    lib.tm_levenshtein_batch(a_flat.ctypes.data_as(_I32P), a_off.ctypes.data_as(_I64P), b_flat.ctypes.data_as(_I32P),
                             b_off.ctypes.data_as(_I64P), len(a_seqs), out.ctypes.data_as(_I64P))
    return out


def _flatten(seqs: Sequence[Sequence]) -> Tuple[np.ndarray, np.ndarray]:
    """Sequences as one int32 array and their ``len(seqs) + 1`` int64 offsets."""
    offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    flat = np.fromiter(itertools.chain.from_iterable(seqs), dtype=np.int32, count=int(offsets[-1]))
    return flat, offsets


def ngram_overlap(a: np.ndarray, b: np.ndarray, max_order: int) -> np.ndarray:
    """Per-order n-gram intersection counts of two int32 id streams, as
    ``(max_order,)`` float64: ``out[n - 1] = sum_g min(count_a(g), count_b(g))``
    over the n-grams ``g`` of order ``n``."""
    lib = load()
    a, b = _as_i32(a), _as_i32(b)
    out = np.zeros(int(max_order), dtype=np.float64)
    lib.tm_ngram_overlap(a.ctypes.data, len(a), b.ctypes.data, len(b), int(max_order), out.ctypes.data)
    return out


def lcs_ids(a: np.ndarray, b: np.ndarray) -> int:
    """Length of the longest common subsequence of two int32 id arrays."""
    lib = load()
    a, b = _as_i32(a), _as_i32(b)
    return int(lib.tm_lcs(a.ctypes.data, len(a), b.ctypes.data, len(b)))


def lcs_union_mark(p: np.ndarray, r: np.ndarray, covered: np.ndarray) -> None:
    """OR the positions of ``r`` that an LCS with ``p`` covers into
    ``covered`` (uint8, contiguous, ``len(r)`` long; written in place)."""
    if covered.dtype != np.uint8 or not covered.flags["C_CONTIGUOUS"] or len(covered) != len(r):
        raise ValueError(f"`covered` must be a contiguous uint8 array of length {len(r)}")
    lib = load()
    p, r = _as_i32(p), _as_i32(r)
    lib.tm_lcs_union_mark(p.ctypes.data, len(p), r.ctypes.data, len(r), covered.ctypes.data)


def eed_score(hyp: str, ref: str, alpha: float, rho: float, deletion: float, insertion: float) -> float:
    """Extended Edit Distance of one sentence pair, over unicode codepoints."""
    lib = load()
    h = np.fromiter((ord(c) for c in hyp), dtype=np.int32, count=len(hyp))
    r = np.fromiter((ord(c) for c in ref), dtype=np.int32, count=len(ref))
    return float(lib.tm_eed(h.ctypes.data_as(_I32P), len(h), r.ctypes.data_as(_I32P), len(r), ord(" "),
                            alpha, rho, deletion, insertion))


def coco_match(ious: np.ndarray, gt_ignore: np.ndarray, thresholds: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """COCO's greedy ground-truth matching over every IoU threshold for one
    (image, class). ``ious`` is (n_det, n_gt), detections sorted by score
    descending and ground truths ignored-last. Returns ``(det_matched,
    det_matched_ignored)``, both (n_thr, n_det) bool."""
    if np.ndim(ious) != 2 or len(gt_ignore) != np.shape(ious)[1]:
        raise ValueError(f"expected (n_det, n_gt) ious and n_gt ignore flags, got {np.shape(ious)} and {len(gt_ignore)}")
    lib = load()
    n_det, n_gt = ious.shape
    n_thr = len(thresholds)
    ious = np.ascontiguousarray(ious, dtype=np.float64)
    gt_ig = np.ascontiguousarray(gt_ignore, dtype=np.uint8)
    thrs = np.ascontiguousarray(thresholds, dtype=np.float64)
    det_matched = np.zeros((n_thr, n_det), dtype=np.uint8)
    det_matched_ig = np.zeros((n_thr, n_det), dtype=np.uint8)
    lib.tm_coco_match(ious.ctypes.data, n_det, n_gt, gt_ig.ctypes.data, thrs.ctypes.data, n_thr,
                      det_matched.ctypes.data, det_matched_ig.ctypes.data)
    return det_matched.astype(bool), det_matched_ig.astype(bool)
