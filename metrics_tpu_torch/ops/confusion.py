"""Unnormalised confusion matrix from class indices: the ``confusion_matrix`` kernel.

Port of ``metrics_tpu/ops/confusion.py``. On a CUDA tensor the matrix comes
from the hand-written kernel in ``csrc/confusion.cu`` (integer atomics, see
the note there); on a CPU tensor from :func:`_confmat_plain`, the JAX
package's one-hot product (``_confmat_lax``) in PyTorch. float32 sums of 0/1
products are exact below 2^24 a cell, so both agree bit for bit.
"""
import ctypes
import functools

import torch
from torch import Tensor

from metrics_tpu_torch.ops import _build, registry

_NAME = "confusion_matrix"


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("confusion")
    lib.confusion_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 2
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
    out = torch.zeros((num_classes, num_classes), dtype=torch.int32, device=target_cls.device)
    if n > 0:
        lib = _lib()
        with torch.cuda.device(out.device):
            stream = torch.cuda.current_stream(out.device).cuda_stream
            err = lib.confusion_launch(target_cls.data_ptr(), pred_cls.data_ptr(), n, num_classes, out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"confusion_matrix kernel launch failed: {lib.confusion_error_string(err).decode()}")
        registry.note_launch(_NAME)
    return out
