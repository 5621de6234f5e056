"""Per-class multiclass stat-score counts: the ``stat_scores`` kernel.

Port of ``metrics_tpu/ops/stat_scores.py``. On a CUDA tensor the counts come
from the hand-written kernel in ``csrc/stat_scores.cu`` (shared-memory
integer atomics, see the note there); on a CPU tensor from
:func:`_stat_counts_plain`, the JAX package's scatter formulation
(``_stat_counts_lax``) in PyTorch. Both are exact integer sums, so they agree
bit for bit. :func:`stat_scores_plan` picks the kernel's branch: one block
for a batch of up to 6,144 rows (one launch, no zeroed output), many blocks
above, global atomics where the ``3C`` histogram does not fit shared memory.

The session axis, :func:`stat_scores_counts_sessions`, is what ``jax.vmap``
of the same counts computes for the multi-tenant service
(:mod:`metrics_tpu_torch.serve`): ``(S, B)`` rows of S sessions in one
launch to ``(S, 3, C)`` counts, each session held to its own ``3C`` cells by
the same wrap-or-drop rule. Its plan (:func:`stat_scores_sessions_plan`)
takes one block a session while ``3C`` fits shared memory, and global
atomics at each session's offset beyond; the launches count under the
branches ``"sessions"`` and ``"sessions-global"``.
"""
import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.ops import _build, registry

_NAME = "stat_scores"
registry.register(_NAME, "cuda", ("Accuracy", "Precision", "Recall", "F1Score", "FBeta", "StatScores", "Specificity"),
                  "multiclass target, prediction and TP counts by one flat scatter (csrc/stat_scores.cu)")
_BRANCHES = ("block", "shared", "global")  # the C launcher's branch codes, in order
# the most rows the one-block branch takes: on an H100 it beats the multi-block branch up to 6,144 rows
# and loses from 8,192 (chip_smoke.py times both at 2,048 to 16,384 rows)
_ONE_BLOCK_ROWS = 6144
_BLOCK_THREADS = 1024
_THREADS = 256  # a block of the shared and global branches
_MAX_BLOCKS = 264  # two blocks on each of an H100's 132 SMs


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("stat_scores")
    lib.stat_scores_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    lib.stat_scores_launch.restype = ctypes.c_int
    lib.stat_scores_sessions_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    lib.stat_scores_sessions_launch.restype = ctypes.c_int
    lib.stat_scores_error_string.argtypes = [ctypes.c_int]
    lib.stat_scores_error_string.restype = ctypes.c_char_p
    return lib


def _stat_counts_plain(target_cls: Tensor, pred_cls: Tensor, correct: Tensor, w: Tensor, num_classes: int):
    """One scatter-add over a length-3C counts vector:
    ``idx = [target, pred + C, target + 2C]``, ``wts = [w, w, correct]``.

    Out-of-range indices follow JAX's ``.at[idx].add``, as the JAX package's
    ``_stat_counts_lax`` meets them: a flat index ``f`` in ``[-3C, 0)`` wraps
    to ``f + 3C``, and one outside ``[-3C, 3C)`` is dropped. So a NaN score
    row (``pred == C``) adds to ``tp[0]``, as it does there.
    """
    dtype = w.dtype
    cells = 3 * num_classes
    idx = torch.cat([target_cls.long(), pred_cls.long() + num_classes, target_cls.long() + 2 * num_classes])
    wts = torch.cat([w, w, correct.to(dtype)])
    idx = torch.where(idx < 0, idx + cells, idx)
    ok = (idx >= 0) & (idx < cells)
    idx = torch.where(ok, idx, 0)
    wts = torch.where(ok, wts, 0).to(dtype)
    counts = torch.zeros(cells, dtype=dtype, device=w.device).index_add_(0, idx, wts)
    return counts[:num_classes], counts[num_classes : 2 * num_classes], counts[2 * num_classes :]


def _check(target_cls: Tensor, pred_cls: Tensor, correct: Tensor, w: Tensor, num_classes: int) -> None:
    n = target_cls.shape[0]
    for name, t, dtype in (
        ("target_cls", target_cls, torch.int32),
        ("pred_cls", pred_cls, torch.int32),
        ("correct", correct, torch.bool),
        ("w", w, torch.int32),
    ):
        if t.dtype != dtype:
            raise TypeError(f"stat_scores_counts: `{name}` must be {dtype}, got {t.dtype}")
        if t.ndim != 1 or t.shape[0] != n:
            raise ValueError(f"stat_scores_counts: `{name}` must have shape ({n},), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"stat_scores_counts: `{name}` must be contiguous")
    if num_classes < 1:
        raise ValueError(f"stat_scores_counts: `num_classes` must be positive, got {num_classes}")


def _grid(n: int) -> int:
    return max(1, min(_MAX_BLOCKS, -(-n // _THREADS)))


def stat_scores_plan(n: int, num_classes: int, shared_optin: int) -> Tuple[str, int, int]:
    """``(branch, blocks, threads)`` of the kernel's launch for ``n`` rows of
    ``num_classes`` classes on a device whose blocks may use ``shared_optin``
    bytes of shared memory.

    ``"block"`` when the ``3C`` int32 histogram fits that limit and ``n`` is
    at most 6,144: one block of 1,024 threads, which writes every cell.
    ``"shared"`` for longer batches and ``"global"`` where the histogram does
    not fit: blocks of 256 threads, one a 256 rows, at most 264, adding into
    a zeroed output.
    """
    if 12 * num_classes > shared_optin:
        return "global", _grid(n), _THREADS
    if n <= _ONE_BLOCK_ROWS:
        return "block", 1, _BLOCK_THREADS
    return "shared", _grid(n), _THREADS


def _stat_counts_kernel(target_cls: Tensor, pred_cls: Tensor, correct: Tensor, w: Tensor, num_classes: int,
                        branch: Optional[str] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch ``csrc/stat_scores.cu`` on checked CUDA inputs; ``branch``
    (``"block"`` or ``"shared"``) overrides the plan's choice in tests and
    timings."""
    n = target_cls.shape[0]
    if n == 0:
        out = torch.zeros((3, num_classes), dtype=torch.int32, device=w.device)
        return out[0], out[1], out[2]
    lib = _lib()
    plan = stat_scores_plan(n, num_classes, registry.device_limits(w.device, lib, _NAME)[1])
    if branch is not None and branch != plan[0]:
        if branch not in ("block", "shared") or plan[0] == "global":
            raise ValueError(f"stat_scores_counts: no {branch!r} branch for {num_classes} classes on this device")
        plan = ("block", 1, _BLOCK_THREADS) if branch == "block" else ("shared", _grid(n), _THREADS)
    name, blocks, threads = plan
    # the block branch writes every cell; the others add into zeros
    out = (torch.empty if name == "block" else torch.zeros)((3, num_classes), dtype=torch.int32, device=w.device)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.stat_scores_launch(
            target_cls.data_ptr(), pred_cls.data_ptr(), correct.data_ptr(), w.data_ptr(),
            n, num_classes, _BRANCHES.index(name), blocks, threads, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"stat_scores kernel launch failed: {lib.stat_scores_error_string(err).decode()}")
    # the model terms are the Hopper kernel's (chip_smoke.py's bound): the four (B,) columns read once and the
    # (3, C) counts written; at most three adds a row (two, and one more a correct row: the count that reads the
    # data is chip_smoke's). The JAX formula's 9nC flops are the TPU's one-hot compares (ops/stat_scores.py:126).
    registry.note_launch(_NAME, name, (n, num_classes), cost_key=(n, num_classes, str(w.dtype).replace("torch.", "")),
                         flops=3.0 * n, bytes_accessed=13.0 * n + 12.0 * num_classes)
    return out[0], out[1], out[2]


def stat_scores_branch(n: int, num_classes: int, device: torch.device) -> str:
    """The branch the kernel takes for ``n`` rows of ``num_classes`` classes on CUDA ``device``."""
    return stat_scores_plan(n, num_classes, registry.device_limits(device, _lib(), _NAME)[1])[0]


def stat_scores_counts(
    target_cls: Tensor, pred_cls: Tensor, correct: Tensor, w: Tensor, num_classes: int
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-class ``(target_count, pred_count, tp)`` for one batch.

    ``target_cls``/``pred_cls`` are ``(B,)`` int32 class indices, ``correct``
    the ``(B,)`` bool hit mask (already masked by validity), ``w`` the ``(B,)``
    int32 0/1 validity weights. Each count is int32 ``(C,)``.
    """
    _check(target_cls, pred_cls, correct, w, num_classes)
    if not registry.use_kernel(target_cls, pred_cls, correct, w):
        return _stat_counts_plain(target_cls, pred_cls, correct, w, num_classes)
    return _stat_counts_kernel(target_cls, pred_cls, correct, w, num_classes)


# ------------------------------------------------------------------ the session axis
_SESSION_THREADS = 256  # a block of the session branch: B = 64 rows at the service's flush, 3C cells to write


def _stat_counts_sessions_plain(target_cls: Tensor, pred_cls: Tensor, correct: Tensor, w: Tensor,
                                num_classes: int) -> Tensor:
    """:func:`_stat_counts_plain` on each of S sessions, as one ``index_add_``
    into ``S * 3C`` cells: ``(S, B)`` inputs to ``(S, 3, C)`` counts. The
    wrap-or-drop rule holds within each session's own ``3C`` cells, so no
    row ever adds to another session."""
    sessions = target_cls.shape[0]
    dtype = w.dtype
    cells = 3 * num_classes
    idx = torch.cat([target_cls.long(), pred_cls.long() + num_classes, target_cls.long() + 2 * num_classes], dim=1)
    wts = torch.cat([w, w, correct.to(dtype)], dim=1)
    idx = torch.where(idx < 0, idx + cells, idx)
    ok = (idx >= 0) & (idx < cells)
    idx = torch.where(ok, idx, 0) + torch.arange(sessions, device=w.device)[:, None] * cells
    wts = torch.where(ok, wts, 0).to(dtype)
    counts = torch.zeros(sessions * cells, dtype=dtype, device=w.device).index_add_(0, idx.reshape(-1), wts.reshape(-1))
    return counts.reshape(sessions, 3, num_classes)


def _check_sessions(target_cls: Tensor, pred_cls: Tensor, correct: Tensor, w: Tensor, num_classes: int) -> None:
    shape = tuple(target_cls.shape)
    if len(shape) != 2:
        raise ValueError(f"stat_scores_counts_sessions: `target_cls` must have shape (S, B), got {shape}")
    for name, t, dtype in (
        ("target_cls", target_cls, torch.int32),
        ("pred_cls", pred_cls, torch.int32),
        ("correct", correct, torch.bool),
        ("w", w, torch.int32),
    ):
        if t.dtype != dtype:
            raise TypeError(f"stat_scores_counts_sessions: `{name}` must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"stat_scores_counts_sessions: `{name}` must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"stat_scores_counts_sessions: `{name}` must be contiguous")
    if num_classes < 1:
        raise ValueError(f"stat_scores_counts_sessions: `num_classes` must be positive, got {num_classes}")


def stat_scores_sessions_plan(sessions: int, n: int, num_classes: int, shared_optin: int) -> Tuple[str, int, int]:
    """``(branch, blocks, threads)`` of the session axis for ``sessions`` x
    ``n`` rows of ``num_classes`` classes: ``"sessions"``, one block of 256
    threads a session, when the ``3C`` int32 histogram fits ``shared_optin``
    bytes; else ``"sessions-global"``, blocks of 256 threads over all rows
    (at most 264) adding into a zeroed output."""
    if 12 * num_classes > shared_optin:
        return "sessions-global", _grid(sessions * n), _THREADS
    return "sessions", sessions, _SESSION_THREADS


def stat_scores_sessions_branch(sessions: int, n: int, num_classes: int, device: torch.device) -> str:
    """The branch the session axis takes for ``sessions`` x ``n`` rows on CUDA ``device``."""
    return stat_scores_sessions_plan(sessions, n, num_classes, registry.device_limits(device, _lib(), _NAME)[1])[0]


def _stat_counts_sessions_kernel(target_cls: Tensor, pred_cls: Tensor, correct: Tensor, w: Tensor,
                                 num_classes: int) -> Tensor:
    """Launch the session axis of ``csrc/stat_scores.cu`` on checked CUDA inputs."""
    sessions, n = target_cls.shape
    lib = _lib()
    name, blocks, threads = stat_scores_sessions_plan(sessions, n, num_classes,
                                                      registry.device_limits(w.device, lib, _NAME)[1])
    alloc = torch.empty if name == "sessions" else torch.zeros  # the block branch writes every cell
    out = alloc((sessions, 3, num_classes), dtype=torch.int32, device=w.device)
    if sessions == 0:
        return out
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.stat_scores_sessions_launch(
            target_cls.data_ptr(), pred_cls.data_ptr(), correct.data_ptr(), w.data_ptr(),
            sessions, n, num_classes, 0 if name == "sessions" else 1, blocks, threads, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"stat_scores session kernel launch failed: {lib.stat_scores_error_string(err).decode()}")
    # the bound's terms: the four (S, B) columns read once, the (S, 3, C) counts written once
    registry.note_launch(_NAME, name, (sessions, n, num_classes),
                         cost_key=("sessions", sessions, n, num_classes, str(w.dtype).replace("torch.", "")),
                         flops=3.0 * sessions * n, bytes_accessed=13.0 * sessions * n + 12.0 * sessions * num_classes)
    return out


def stat_scores_counts_sessions(target_cls: Tensor, pred_cls: Tensor, correct: Tensor, w: Tensor,
                                num_classes: int) -> Tensor:
    """Per-session, per-class ``[target_count, pred_count, tp]`` for S
    batches at once: ``(S, B)`` int32 classes, bool hits (already masked by
    validity) and int32 0/1 weights to int32 ``(S, 3, C)``. Row ``s`` equals
    :func:`stat_scores_counts` of session ``s``'s rows, stacked."""
    _check_sessions(target_cls, pred_cls, correct, w, num_classes)
    if not registry.use_kernel(target_cls, pred_cls, correct, w):
        return _stat_counts_sessions_plain(target_cls, pred_cls, correct, w, num_classes)
    return _stat_counts_sessions_kernel(target_cls, pred_cls, correct, w, num_classes)
