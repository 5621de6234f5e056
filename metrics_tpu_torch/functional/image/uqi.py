"""Universal image quality index: port of ``metrics_tpu/functional/image/uqi.py``.

The same five-statistics depthwise convolution as SSIM, without SSIM's
constants: a flat window (both variances 0) gives NaN, as in the JAX
package. The map is cropped by ``slice(p, size - p)`` on each axis, as SSIM
crops it. The JAX package slices ``p:-p``, which is empty for a 1-wide
window (``p = 0``), so there ``kernel_size=(1, 11)`` gives NaN (a reference
fault not copied; ROADMAP.md Queue C).
"""
from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.image.helper import _depthwise_conv, _gaussian_kernel_2d, _reflection_pad
from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.data import dtype_name
from metrics_tpu_torch.utilities.distributed import reduce


def _uqi_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Check dtypes and shapes: ``(B, C, H, W)``."""
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {dtype_name(preds.dtype)} and target: {dtype_name(target.dtype)}."
        )
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    return preds, target


def _uqi_compute(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
) -> Tensor:
    """The UQI map of each image, cropped and reduced by ``reduction``
    (``data_range`` is accepted and unused, as in the JAX package)."""
    if len(kernel_size) != 2 or len(sigma) != 2:
        raise ValueError(
            "Expected `kernel_size` and `sigma` to have the length of two."
            f" Got kernel_size: {len(kernel_size)} and sigma: {len(sigma)}."
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    channel = preds.shape[1]
    kernel = _gaussian_kernel_2d(channel, kernel_size, sigma, preds.dtype, preds.device)
    pads = [(kernel_size[0] - 1) // 2, (kernel_size[1] - 1) // 2]

    preds_p = _reflection_pad(preds, pads)
    target_p = _reflection_pad(target, pads)

    input_list = torch.cat((preds_p, target_p, preds_p * preds_p, target_p * target_p, preds_p * target_p))
    outputs = _depthwise_conv(input_list, kernel)
    mu_pred, mu_target, e_pred_sq, e_target_sq, e_pred_target = outputs.chunk(5)

    mu_pred_sq = mu_pred**2
    mu_target_sq = mu_target**2
    mu_pred_target = mu_pred * mu_target

    sigma_pred_sq = e_pred_sq - mu_pred_sq
    sigma_target_sq = e_target_sq - mu_target_sq
    sigma_pred_target = e_pred_target - mu_pred_target

    upper = 2 * sigma_pred_target
    lower = sigma_pred_sq + sigma_target_sq

    uqi_idx = ((2 * mu_pred_target) * upper) / ((mu_pred_sq + mu_target_sq) * lower)
    uqi_idx = uqi_idx[..., slice(pads[0], uqi_idx.shape[-2] - pads[0]), slice(pads[1], uqi_idx.shape[-1] - pads[1])]
    return reduce(uqi_idx, reduction)


def universal_image_quality_index(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
) -> Tensor:
    """UQI: SSIM's structure and luminance terms without its constants.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import universal_image_quality_index
        >>> preds = torch.rand(8, 1, 16, 16, generator=torch.manual_seed(0))
        >>> target = preds * 0.75
        >>> float(universal_image_quality_index(preds, target)) > 0.9
        True
    """
    preds, target = _uqi_update(preds, target)
    return _uqi_compute(preds, target, kernel_size, sigma, reduction, data_range)
