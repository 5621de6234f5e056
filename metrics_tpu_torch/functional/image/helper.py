"""Gaussian windows, padding, pooling and the depthwise convolution of the
image metrics: port of ``metrics_tpu/functional/image/helper.py``.

The windows are built on the input's device in its dtype. The depthwise
convolution is ``torch.nn.functional.conv2d``/``conv3d`` with ``groups=C``,
as the JAX package runs XLA's convolution outside any Pallas kernel. It runs
in full float32: the JAX package asks for ``Precision.HIGHEST``, because the
window moments lose about 1e-3 at lower precision, and cuDNN runs float32
convolutions in TF32 by default (``torch.backends.cudnn.allow_tf32``).
:func:`_depthwise_conv` turns that flag off for its own call and restores the
caller's value afterwards, whatever it was.
"""
from contextlib import contextmanager
from typing import Iterator, Sequence

import torch
import torch.nn.functional as F
from torch import Tensor


def _gaussian(kernel_size: int, sigma: float, dtype: torch.dtype, device: torch.device) -> Tensor:
    """1-D gaussian window of shape ``(1, kernel_size)``, normalized to sum 1."""
    dist = torch.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, 1.0, dtype=dtype, device=device)
    gauss = torch.exp(-torch.square(dist / sigma) / 2)
    return (gauss / gauss.sum())[None, :]


def _gaussian_kernel_2d(
    channel: int, kernel_size: Sequence[int], sigma: Sequence[float], dtype: torch.dtype, device: torch.device
) -> Tensor:
    """Depthwise 2-D gaussian window of shape ``(C, 1, kh, kw)``, contiguous.

    The outer product is a broadcast multiply: one product a tap, the bits
    of the JAX package's ``(kh, 1) @ (1, kw)``."""
    kernel_x = _gaussian(kernel_size[0], sigma[0], dtype, device)
    kernel_y = _gaussian(kernel_size[1], sigma[1], dtype, device)
    kernel = kernel_x.T * kernel_y
    return kernel.expand(channel, 1, kernel_size[0], kernel_size[1]).contiguous()


def _gaussian_kernel_3d(
    channel: int, kernel_size: Sequence[int], sigma: Sequence[float], dtype: torch.dtype, device: torch.device
) -> Tensor:
    """Depthwise 3-D gaussian window of shape ``(C, 1, kh, kw, kd)``, contiguous."""
    kernel_x = _gaussian(kernel_size[0], sigma[0], dtype, device)
    kernel_y = _gaussian(kernel_size[1], sigma[1], dtype, device)
    kernel_z = _gaussian(kernel_size[2], sigma[2], dtype, device)
    kernel = (kernel_x.T * kernel_y)[:, :, None] * kernel_z.reshape(1, 1, -1)
    return kernel.expand(channel, 1, *kernel_size).contiguous()


@contextmanager
def _full_float32() -> Iterator[None]:
    """cuDNN's float32 convolutions and cuBLAS's float32 products without TF32
    for the block; the caller's flags are restored on the way out."""
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def _depthwise_conv(x: Tensor, kernel: Tensor) -> Tensor:
    """Depthwise valid convolution of an ``(N, C, H, W)`` or ``(N, C, D, H, W)``
    input with a ``(C, 1, *spatial)`` window (``groups=C``), in full float32."""
    conv = F.conv2d if kernel.ndim == 4 else F.conv3d
    with _full_float32():
        return conv(x, kernel, groups=kernel.shape[0])


def _reflection_pad(x: Tensor, pads: Sequence[int]) -> Tensor:
    """Reflection-pad the trailing spatial dims of an ``(N, C, *spatial)`` tensor.

    ``F.pad`` reflects only a pad shorter than its dim. A longer one (UQI's
    window past half the image) pads by replication instead: the metrics
    crop at least the pad from each side of their maps, so nothing computed
    from those pixels is kept."""
    flat = [p for pad in reversed(pads) for p in (pad, pad)]
    fits = all(p < s for p, s in zip(pads, x.shape[2:]))
    return F.pad(x, flat, mode="reflect" if fits else "replicate")


def _avg_pool(x: Tensor, window: int = 2) -> Tensor:
    """Non-overlapping average pooling over the trailing spatial dims; an odd
    size drops its last row (the JAX package's ``reduce_window`` VALID)."""
    pool = F.avg_pool2d if x.ndim == 4 else F.avg_pool3d
    return pool(x, window)
