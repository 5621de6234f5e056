"""Relevance labels reordered by descending score: the ``retrieval_sort`` kernel.

Port of ``metrics_tpu/ops/retrieval.py``. Every retrieval metric starts from

    target[argsort(-preds, stable=True)]

on one query ``(L,)`` or on each row of a padded ``(Q, L)`` matrix. On a
CUDA tensor it comes from the hand-written kernel in
``csrc/retrieval_sort.cu``; on a CPU tensor from
:func:`_sorted_by_preds_plain`, the JAX package's production formulation in
PyTorch. The kernel has two branches, chosen from ``L`` alone
(:func:`sort_branch`): rows of up to :data:`L_MAX` = 16,384 go through a
bitonic sort of one block a row in registers and shared memory, longer rows
through the all-pairs stable rank. Both put ``+0.0`` and ``-0.0`` in index
order and NaN scores last, as ``jnp.argsort`` does
(``torch.sort(descending=True)`` would put NaN first), and both move the
label's bits unchanged, so they agree with the plain version bit for bit.
"""
import ctypes
import functools

import torch
from torch import Tensor

from metrics_tpu_torch.ops import _build, registry

_NAME = "retrieval_sort"
# the longest row the bitonic branch sorts: 16,384 composites of 8 bytes (and
# a pad word every 16) fit a block's opt-in shared memory, 32,768 do not
L_MAX = 16384
# label dtypes widened to a 32-bit cell for the kernel and narrowed back (exact)
_WIDEN = {
    torch.bool: torch.int32,
    torch.uint8: torch.int32,
    torch.int8: torch.int32,
    torch.int16: torch.int32,
    torch.float16: torch.float32,
    torch.bfloat16: torch.float32,
}
_WORDS = {torch.int32: 4, torch.float32: 4, torch.int64: 8, torch.float64: 8}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("retrieval_sort")
    lib.retrieval_sort_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    lib.retrieval_sort_launch.restype = ctypes.c_int
    lib.retrieval_sort_error_string.argtypes = [ctypes.c_int]
    lib.retrieval_sort_error_string.restype = ctypes.c_char_p
    return lib


def sort_branch(l: int, all_pairs: bool = False) -> str:
    """The kernel's branch for rows of length ``l``: ``"bitonic"`` up to
    :data:`L_MAX`, else ``"all_pairs"``; ``all_pairs=True`` forces the latter."""
    return "all_pairs" if all_pairs or l > L_MAX else "bitonic"


def _sorted_by_preds_plain(preds: Tensor, target: Tensor) -> Tensor:
    """The stable argsort gather, along the last dimension."""
    return torch.gather(target, -1, torch.argsort(-preds, dim=-1, stable=True))


def _sorted_by_preds_kernel(preds: Tensor, target: Tensor, all_pairs: bool = False) -> Tensor:
    """Launch ``csrc/retrieval_sort.cu`` on ``(Q, L)`` CUDA inputs; ``all_pairs``
    forces the all-pairs branch at any ``L`` (for tests and timings)."""
    if preds.dtype != torch.float32:
        raise TypeError(f"sorted_by_preds: `preds` must be torch.float32, got {preds.dtype}")
    if preds.ndim != 2 or target.shape != preds.shape:
        raise ValueError(
            f"sorted_by_preds: `preds` and `target` must be (Q, L) alike, got {tuple(preds.shape)} and {tuple(target.shape)}"
        )
    if not preds.is_contiguous() or not target.is_contiguous():
        raise ValueError("sorted_by_preds: `preds` and `target` must be contiguous")
    if target.dtype not in _WORDS:
        raise TypeError(f"sorted_by_preds: no kernel for a {target.dtype} target")
    q, l = preds.shape
    if q >= 2**31 or l >= 2**24:
        raise ValueError(f"sorted_by_preds: ({q}, {l}) is beyond the kernel's grid (Q < 2^31, L < 2^24)")
    out = torch.empty_like(target)
    if q == 0 or l == 0:
        return out
    lib = _lib()
    branch = sort_branch(l, all_pairs)
    use_all_pairs = branch == "all_pairs"
    with torch.cuda.device(preds.device):
        stream = torch.cuda.current_stream(preds.device).cuda_stream
        err = lib.retrieval_sort_launch(
            preds.data_ptr(), target.data_ptr(), q, l, _WORDS[target.dtype], int(use_all_pairs), out.data_ptr(), stream
        )
    if err != 0:
        raise RuntimeError(f"retrieval_sort kernel launch failed: {lib.retrieval_sort_error_string(err).decode()}")
    registry.note_launch(_NAME, branch, (q, l))
    return out


def sorted_by_preds(preds: Tensor, target: Tensor) -> Tensor:
    """``target`` reordered by descending ``preds``, stable: on ``(L,)`` one
    query, on ``(Q, L)`` each row alone. Slice ``[..., :k]`` for top-k.

    The scores are compared in float32; the output has ``target``'s dtype
    and bits. One kernel launch per call on a CUDA tensor.
    """
    if preds.shape != target.shape or preds.ndim not in (1, 2):
        raise ValueError(
            f"sorted_by_preds expects (L,) or (Q, L) `preds` and `target` alike, got {tuple(preds.shape)} and"
            f" {tuple(target.shape)}"
        )
    preds = preds.to(torch.float32)
    if not registry.use_kernel(preds, target):
        return _sorted_by_preds_plain(preds, target)
    rows = preds.reshape(-1, preds.shape[-1]).contiguous()
    wide = _WIDEN.get(target.dtype, target.dtype)
    cells = target.reshape(rows.shape).to(wide).contiguous()
    return _sorted_by_preds_kernel(rows, cells).to(target.dtype).reshape(target.shape)
