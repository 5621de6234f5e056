"""Binned TP/FP/FN over a threshold sweep: the ``binned_stats`` kernel.

Port of ``metrics_tpu/ops/binned_stats.py``. For ``(N, C)`` scores, ``(N, C)``
targets and ``(T,)`` thresholds, every class ``c`` and threshold ``t`` get::

    TP[c, t] = sum_n target[n, c] * (preds[n, c] >= thr[t])
    FP[c, t] = sum_n (1 - target[n, c]) * (preds[n, c] >= thr[t])
    FN[c, t] = sum_n target[n, c] * (preds[n, c] <  thr[t])

On a CUDA tensor the counts come from the hand-written kernel in
``csrc/binned_stats.cu`` (integer counters and atomics, see the note there),
which reduces ``TP``, the prediction-positive count ``P`` and the per-class
positive count ``pos``; ``FP = P - TP`` and ``FN = pos - TP``. On a CPU
tensor they come from :func:`_binned_stat_scores_plain`, the JAX package's
XLA formulation (``_binned_stat_scores_xla``) in PyTorch. All are exact
integer counts returned as float32, exact below 2^24 rows, so both agree bit
for bit.
"""
import ctypes
import functools
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.ops import _build, registry

_NAME = "binned_stats"
# cells of the plain version's (rows, C, T) bool compare in one chunk of rows
_PLAIN_CELLS = 1 << 26
_MAX_ROWS = 1 << 24  # float32 counts stay exact below this


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("binned_stats")
    lib.binned_stats_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    lib.binned_stats_launch.restype = ctypes.c_int
    lib.binned_stats_error_string.argtypes = [ctypes.c_int]
    lib.binned_stats_error_string.restype = ctypes.c_char_p
    return lib


def _binned_stat_scores_plain(preds: Tensor, target: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """One broadcast compare and three reductions, over chunks of rows so
    that the ``(rows, C, T)`` bool compare stays near 64 MB (integer sums do
    not depend on the chunking)."""
    n, c = preds.shape
    t = thresholds.shape[0]
    step = max(1, _PLAIN_CELLS // max(1, c * t))
    sums = torch.zeros((3, c, t), dtype=torch.int64, device=preds.device)
    for start in range(0, n, step):
        tgt = target[start : start + step, :, None]
        hit = preds[start : start + step, :, None] >= thresholds[None, None, :]
        sums[0] += (tgt & hit).sum(dim=0)
        sums[1] += (~tgt & hit).sum(dim=0)
        sums[2] += (tgt & ~hit).sum(dim=0)
    tp, fp, fn = sums.to(torch.float32)
    return tp, fp, fn


def _binned_stat_scores_kernel(preds: Tensor, target: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch ``csrc/binned_stats.cu`` on canonical CUDA inputs."""
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
    counts = torch.zeros(2 * c * t + c, dtype=torch.int32, device=preds.device)  # tp, p, pos
    out = torch.empty((3, c, t), dtype=torch.float32, device=preds.device)
    lib = _lib()
    with torch.cuda.device(preds.device):
        stream = torch.cuda.current_stream(preds.device).cuda_stream
        err = lib.binned_stats_launch(
            preds.data_ptr(), target.data_ptr(), thresholds.data_ptr(), n, c, t, counts.data_ptr(), out.data_ptr(), stream
        )
    if err != 0:
        raise RuntimeError(f"binned_stats kernel launch failed: {lib.binned_stats_error_string(err).decode()}")
    registry.note_launch(_NAME)
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
