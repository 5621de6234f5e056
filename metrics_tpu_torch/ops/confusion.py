"""Unnormalised confusion matrix from class indices: the ``confusion_matrix`` kernel.

Port of ``metrics_tpu/ops/confusion.py``. On a CUDA tensor the matrix comes
from the hand-written kernel in ``csrc/confusion.cu`` (shared-memory integer
counts, one launch, every cell stored by the kernel; see the note there); on
a CPU tensor from :func:`_confmat_plain`, the JAX package's one-hot product
(``_confmat_lax``) in PyTorch. float32 sums of 0/1 products are exact below
2^24 a cell, so both agree bit for bit. :func:`confusion_plan` picks the
kernel's branch: bands of target rows for many classes, the whole table in
each block with the rows split over blocks for few classes and long batches.
"""
import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.ops import _build, registry

_NAME = "confusion_matrix"
_LIB = "confusion"  # the library's export prefix: csrc/confusion.cu
_BRANCHES = ("band", "split")  # the C launcher's branch codes, in order
# The split branch takes a batch of at least two rows a cell of its table, and gives each block at least
# _SPLIT_ROWS_PER_BLOCK rows, on one block where that makes fewer than _SPLIT_MIN_BLOCKS: on an H100 the
# band wins below two rows a cell (C = 64 to 240) and the split above, 8,192 rows a block did best, and two
# blocks lost to one (chip_smoke.py times both branches, and the split on 1 to 128 blocks, at C = 20 to 240
# and 1,024 to 2,097,152 rows).
_SPLIT_ROWS_PER_CELL = 2
_SPLIT_ROWS_PER_BLOCK = 8192
_SPLIT_MIN_BLOCKS = 4
# one uint32 ticket per (device, stream), 0 between launches: the split branch's last block resets it
_tickets: Dict[Tuple[torch.device, int], Tensor] = {}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    lib.confusion_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
    lib.confusion_launch.restype = ctypes.c_int
    lib.confusion_error_string.argtypes = [ctypes.c_int]
    lib.confusion_error_string.restype = ctypes.c_char_p
    return lib


def _confmat_plain(target_cls: Tensor, pred_cls: Tensor, num_classes: int) -> Tensor:
    """``onehot(target).T @ onehot(pred)``; a label outside ``[0, C)`` matches no class."""
    classes = torch.arange(num_classes, device=target_cls.device)
    oh_t = (target_cls.reshape(-1, 1) == classes).float()
    oh_p = (pred_cls.reshape(-1, 1) == classes).float()
    return (oh_t.T @ oh_p).to(torch.int32)


def band_shared_bytes(rows: int, cols: int) -> int:
    """Shared memory of a band tile of ``rows`` x ``cols`` int32 cells: the
    tile, up to 3 words of offset, in whole 16-byte words."""
    return (rows * cols + 6) // 4 * 16


def split_shared_bytes(num_classes: int) -> int:
    """Shared memory of the split branch's whole ``C x C`` int32 table, in
    whole 16-byte words, and 16 bytes for its static flag."""
    return -(-num_classes * num_classes // 4) * 16 + 16


def _split_plan(n: int, num_classes: int, sms: int, blocks: Optional[int] = None) -> Tuple[str, int, int]:
    if blocks is None:
        # a block's rows (8n / blocks bytes) against the last block's sum of the tables (4 * blocks * C * C
        # bytes) are least in sum at blocks = sqrt(2n) / C; twice that measured best on an H100
        blocks = min(sms, n // _SPLIT_ROWS_PER_BLOCK, math.isqrt(8 * n) // num_classes)
        blocks = blocks if blocks >= _SPLIT_MIN_BLOCKS else 1
    return "split", max(1, blocks), 1


def _band_plan(num_classes: int, sms: int, shared_optin: int) -> Tuple[str, int, int]:
    c = num_classes
    rows = min(-(-c // sms), c)
    while rows > 1 and band_shared_bytes(rows, c) > shared_optin:
        rows -= 1
    if band_shared_bytes(rows, c) <= shared_optin:
        return "band", rows, c
    return "band", 1, (shared_optin // 16) * 4 - 6


def confusion_plan(n: int, num_classes: int, sms: int, shared_optin: int) -> Tuple[str, int, int]:
    """``(branch, a, b)`` of the kernel's launch for ``n`` rows of
    ``num_classes`` classes on a device of ``sms`` SMs whose blocks may use
    ``shared_optin`` bytes of shared memory.

    ``("split", blocks, 1)`` when the whole table fits and the batch has at
    least two rows a cell: ``sqrt(8n) / C`` blocks (the last block sums
    their tables), at most one an SM and one a 8,192 rows, and one block
    where that would give fewer than four. Otherwise ``("band", rows,
    cols)``: tiles of ``rows`` target rows by all ``C`` columns, as few rows
    as give at most one tile an SM; past the shared-memory limit of a
    one-row band, tiles of one row by ``cols`` columns.
    """
    if split_shared_bytes(num_classes) <= shared_optin and n >= _SPLIT_ROWS_PER_CELL * num_classes**2:
        return _split_plan(n, num_classes, sms)
    return _band_plan(num_classes, sms, shared_optin)


def _ticket(device: torch.device) -> Tensor:
    """The split branch's ticket for the current stream of ``device``: zeroed
    once, then reset by each launch's last block. A launch captured into a
    CUDA graph gets a ticket of its own, zeroed by a node of that graph, so
    that no two graphs, and no graph and an eager launch, share one."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(1, dtype=torch.int32, device=device)
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    if key not in _tickets:
        _tickets[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _tickets[key]


def branch_name(branch: str, a: int, b: int) -> str:
    """The name a launch is counted under: ``"band"``, ``"split"`` (one block)
    or ``"split, 128 blocks"``."""
    return f"split, {a} blocks" if branch == "split" and a > 1 else branch


def _confmat_kernel(target_cls: Tensor, pred_cls: Tensor, num_classes: int, branch: Optional[str] = None,
                    blocks: Optional[int] = None) -> Tensor:
    """Launch ``csrc/confusion.cu`` on checked CUDA inputs. ``branch``
    (``"band"`` or ``"split"``) overrides the plan's choice, and ``blocks``
    the split branch's block count, in tests and timings."""
    n = target_cls.shape[0]
    device = target_cls.device
    if n == 0:
        return torch.zeros((num_classes, num_classes), dtype=torch.int32, device=device)
    lib = _lib()
    sms, optin = registry.device_limits(device, lib, _LIB)
    if branch == "split" or (branch is None and blocks is not None):
        if split_shared_bytes(num_classes) > optin:
            raise ValueError(f"confusion_matrix_counts: no 'split' branch for {num_classes} classes on this device")
        plan = _split_plan(n, num_classes, sms, blocks)
    elif branch == "band":
        plan = _band_plan(num_classes, sms, optin)
    elif branch is None:
        plan = confusion_plan(n, num_classes, sms, optin)
    else:
        raise ValueError(f"confusion_matrix_counts: no {branch!r} branch")
    name, a, b = plan
    out = torch.empty((num_classes, num_classes), dtype=torch.int32, device=device)
    workspace = ticket = None
    if name == "split" and a > 1:  # a row of int4s a block
        workspace = torch.empty(a * -(-num_classes * num_classes // 4) * 4, dtype=torch.int32, device=device)
        ticket = _ticket(device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.confusion_launch(
            target_cls.data_ptr(), pred_cls.data_ptr(), n, num_classes, _BRANCHES.index(name), a, b, out.data_ptr(),
            None if workspace is None else workspace.data_ptr(), None if ticket is None else ticket.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"confusion_matrix kernel launch failed: {lib.confusion_error_string(err).decode()}")
    registry.note_launch(_NAME, branch_name(name, a, b), (n, num_classes))
    return out


def confusion_branch(n: int, num_classes: int, device: torch.device) -> str:
    """The name of the launch the kernel makes for ``n`` rows of ``num_classes`` classes on CUDA ``device``."""
    return branch_name(*confusion_plan(n, num_classes, *registry.device_limits(device, _lib(), _LIB)))


def confusion_matrix_counts(target_cls: Tensor, pred_cls: Tensor, num_classes: int) -> Tensor:
    """``(C, C)`` int32 confusion matrix, rows by target, columns by prediction,
    from ``(B,)`` int32 class indices."""
    n = target_cls.shape[0] if target_cls.ndim == 1 else -1
    for name, t in (("target_cls", target_cls), ("pred_cls", pred_cls)):
        if t.dtype != torch.int32:
            raise TypeError(f"confusion_matrix_counts: `{name}` must be torch.int32, got {t.dtype}")
        if t.ndim != 1 or t.shape[0] != n:
            raise ValueError(f"confusion_matrix_counts: `{name}` must be 1-D of one length, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"confusion_matrix_counts: `{name}` must be contiguous")
    if num_classes < 1:
        raise ValueError(f"confusion_matrix_counts: `num_classes` must be positive, got {num_classes}")
    if not registry.use_kernel(target_cls, pred_cls):
        return _confmat_plain(target_cls, pred_cls, num_classes)
    if n >= 2**31:
        raise ValueError(f"confusion_matrix_counts: {n} rows is beyond the kernel's int32 row count")
    return _confmat_kernel(target_cls, pred_cls, num_classes)
