"""Binned TP/FP/FN over a threshold sweep: the ``binned_stats`` kernel.

Port of ``metrics_tpu/ops/binned_stats.py``. For ``(N, C)`` scores, ``(N, C)``
targets and ``(T,)`` thresholds, every class ``c`` and threshold ``t`` get::

    TP[c, t] = sum_n target[n, c] * (preds[n, c] >= thr[t])
    FP[c, t] = sum_n (1 - target[n, c]) * (preds[n, c] >= thr[t])
    FN[c, t] = sum_n target[n, c] * (preds[n, c] <  thr[t])

On a CUDA tensor the counts come from the hand-written kernel in
``csrc/binned_stats.cu``, which reduces ``TP``, the prediction-positive count
``P`` and the per-class positive count ``pos``; ``FP = P - TP`` and
``FN = pos - TP``. :func:`binned_plan` picks its branch: up to 1,024
thresholds it bins each score by a search in the sorted thresholds and
suffix-sums a per-class shared-memory histogram, in one launch (``"hist"``);
above, the thresholds' broadcast compare with register counters
(``"compare"``, two launches and a zeroed scratch). On a CPU tensor the
counts come from :func:`_binned_stat_scores_plain`, the broadcast compare
of the JAX package's XLA formulation (``_binned_stat_scores_xla``) in
PyTorch, reducing two of its three counts. All are exact integer
counts returned as float32, exact below 2^24 rows, so they agree bit for bit.
"""
import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.ops import _build, registry

_NAME = "binned_stats"
# cells of the plain version's (rows, C, T) bool compare in one chunk of rows
_PLAIN_CELLS = 1 << 26
_MAX_ROWS = 1 << 24  # float32 counts stay exact below this
_CLASS_TILE = 8  # classes a block of the histogram branch: one 32-byte sector of a row
_HIST_THREADS = 1024  # a block of the histogram branch, one threshold a thread when ranking
_COPIES = 4  # histogram copies a block: one for each row group of a warp
_MAX_PACKED_ROWS = 65535  # rows a launch with 16-bit packed counters holds
_MAX_CLUSTER = 8  # blocks a thread-block cluster may have on any Hopper card
_ROWS_PER_BLOCK = 1024  # one pass of a block's threads: above it, the plan splits a tile's rows


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("binned_stats")
    lib.binned_stats_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3
    lib.binned_stats_launch.restype = ctypes.c_int
    lib.binned_stats_hist_bytes.argtypes = [ctypes.c_int] * 2
    lib.binned_stats_hist_bytes.restype = ctypes.c_longlong
    lib.binned_stats_error_string.argtypes = [ctypes.c_int]
    lib.binned_stats_error_string.restype = ctypes.c_char_p
    return lib


def _binned_stat_scores_plain(preds: Tensor, target: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """One broadcast compare and two reductions, the hits ``P`` and the true
    hits ``TP``, over chunks of rows so that the ``(rows, C, T)`` bool
    compare stays near 64 MB (integer sums do not depend on the chunking);
    then ``FP = P - TP`` and ``FN = pos - TP``, exact in integers."""
    n, c = preds.shape
    t = thresholds.shape[0]
    step = max(1, _PLAIN_CELLS // max(1, c * t))
    sums = torch.zeros((2, c, t), dtype=torch.int64, device=preds.device)
    for start in range(0, n, step):
        hit = preds[start : start + step, :, None] >= thresholds[None, None, :]
        sums[0] += hit.sum(dim=0)
        sums[1] += (hit & target[start : start + step, :, None]).sum(dim=0)
    p, tp = sums
    pos = target.sum(dim=0, dtype=torch.int64)[:, None]
    return tp.to(torch.float32), (p - tp).to(torch.float32), (pos - tp).to(torch.float32)


def hist_shared_bytes(t: int, wide: bool) -> int:
    """Shared memory of a histogram-branch block for ``t`` thresholds: ``t``
    64-bit composites and ``t`` sorted indices, a search tree of the least
    power of two above ``t`` leaves, 4 copies x 8 classes x an odd stride of
    at least ``t + 1`` bins, and each class's totals of its chunks of 32
    bins, in one 32-bit plane (or two when ``wide``). ``hist_layout`` in
    ``csrc/binned_stats.cu`` lays it out, and its ``binned_stats_hist_bytes``
    export gives the same count on the card's side."""
    leaves, planes, chunks = 1 << t.bit_length(), 2 if wide else 1, (t + 32) // 32
    return 12 * t + 4 * (leaves - 1) + 4 * planes * _COPIES * _CLASS_TILE * ((t + 1) | 1) + 4 * planes * _CLASS_TILE * chunks


def hist_max_thresholds(wide: bool, shared_optin: int) -> int:
    """The most thresholds the histogram branch takes (packed or ``wide``)."""
    t = _HIST_THREADS
    while t > 0 and hist_shared_bytes(t, wide) > shared_optin:
        t -= 1
    return t


def binned_plan(n: int, c: int, t: int, sms: int, shared_optin: int) -> Tuple[str, int, bool]:
    """``(branch, cluster, wide)`` of the kernel's launch for ``n`` rows,
    ``c`` classes and ``t`` thresholds on a device of ``sms`` SMs whose blocks
    may use ``shared_optin`` bytes of shared memory.

    ``"hist"`` up to 1,024 thresholds (one a thread when the block ranks
    them) whose histogram fits that limit: one launch of a block a tile of
    8 classes, each walking all ``n`` rows, or, where the tiles leave SMs
    idle and a block would walk more than 1,024 rows (one pass of its
    1,024 threads), of thread-block clusters of up to 8 blocks that split
    the tile's rows: ``n / 1024`` blocks, at most ``sms // tiles``. A block
    of 1,024 threads has an SM to itself, so more would run in waves, and
    at 1,024 rows or fewer a cluster's barriers cost more than the rows it
    spreads. ``wide`` (two 32-bit counter planes in place of packed 16-bit
    halves) past 65,535 rows. Otherwise ``"compare"``: the earlier design,
    with its own grid.
    """
    wide = n > _MAX_PACKED_ROWS
    if t > _HIST_THREADS or hist_shared_bytes(t, wide) > shared_optin:
        return "compare", 1, False
    tiles = -(-c // _CLASS_TILE)
    return "hist", max(1, min(-(-n // _ROWS_PER_BLOCK), _MAX_CLUSTER, sms // tiles)), wide


def branch_name(branch: str, cluster: int, wide: bool) -> str:
    """The name a launch of ``(branch, cluster, wide)`` is counted under:
    ``"hist"``, ``"hist, clusters of 4"``, ``"hist, wide"`` or ``"compare"``."""
    return branch + (f", clusters of {cluster}" if cluster > 1 else "") + (", wide" if wide else "")


def binned_branch(n: int, c: int, t: int, device: torch.device) -> Tuple[str, int, bool]:
    """:func:`binned_plan` on CUDA ``device``."""
    return binned_plan(n, c, t, *registry.device_limits(device, _lib(), _NAME))


def _binned_stat_scores_kernel(preds: Tensor, target: Tensor, thresholds: Tensor, compare: bool = False,
                               cluster: Optional[int] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch ``csrc/binned_stats.cu`` on canonical CUDA inputs; ``compare``
    forces the compare branch and ``cluster`` (1 to 8) the histogram
    branch's cluster size (tests and timings)."""
    for name, x, dtype, ndim in (
        ("preds", preds, torch.float32, 2),
        ("target", target, torch.bool, 2),
        ("thresholds", thresholds, torch.float32, 1),
    ):
        if x.dtype != dtype:
            raise TypeError(f"binned_stat_scores: `{name}` must be {dtype}, got {x.dtype}")
        if x.ndim != ndim:
            raise ValueError(f"binned_stat_scores: `{name}` must be {ndim}-D, got shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"binned_stat_scores: `{name}` must be contiguous")
    if target.shape != preds.shape:
        raise ValueError(f"binned_stat_scores: `target` {tuple(target.shape)} must match `preds` {tuple(preds.shape)}")
    n, c = preds.shape
    t = thresholds.shape[0]
    if n >= _MAX_ROWS:
        raise ValueError(f"binned_stat_scores: {n} rows; the float32 counts are exact only below 2^24 rows a batch")
    if n == 0 or c == 0 or t == 0:
        out = torch.zeros((3, c, t), dtype=torch.float32, device=preds.device)
        return out[0], out[1], out[2]
    lib = _lib()
    branch, planned, wide = ("compare", 1, False) if compare else binned_branch(n, c, t, preds.device)
    cluster = planned if cluster is None else cluster
    # the histogram branch writes every cell; the compare branch adds into a zeroed tp, p, pos scratch
    counts = torch.zeros(2 * c * t + c, dtype=torch.int32, device=preds.device) if branch == "compare" else None
    out = torch.empty((3, c, t), dtype=torch.float32, device=preds.device)
    with torch.cuda.device(preds.device):
        stream = torch.cuda.current_stream(preds.device).cuda_stream
        err = lib.binned_stats_launch(
            preds.data_ptr(), target.data_ptr(), thresholds.data_ptr(), n, c, t, int(branch == "compare"), cluster,
            int(wide), None if counts is None else counts.data_ptr(), out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"binned_stats kernel launch failed: {lib.binned_stats_error_string(err).decode()}")
    registry.note_launch(_NAME, branch_name(branch, cluster, wide), (n, c, t))
    return out[0], out[1], out[2]


def binned_stat_scores(preds: Tensor, target: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Binned ``(tp, fp, fn)`` over ``(N, C)`` scores and ``(T,)`` thresholds,
    each ``(C, T)`` float32.

    ``target`` is canonicalised to ``target == 1`` first, and the scores and
    thresholds are compared in float32. The thresholds may be unsorted or
    repeat. An empty batch gives zeros and launches nothing.
    """
    if preds.ndim != 2 or target.shape != preds.shape or thresholds.ndim != 1:
        raise ValueError(
            "binned_stat_scores expects (N, C) `preds` and `target` and (T,) `thresholds`, got"
            f" {tuple(preds.shape)}, {tuple(target.shape)} and {tuple(thresholds.shape)}"
        )
    target = (target == 1).contiguous()
    preds = preds.to(torch.float32).contiguous()
    thresholds = thresholds.to(torch.float32).contiguous()
    if not registry.use_kernel(preds, target, thresholds):
        return _binned_stat_scores_plain(preds, target, thresholds)
    return _binned_stat_scores_kernel(preds, target, thresholds)
