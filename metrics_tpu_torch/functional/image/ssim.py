"""SSIM and multi-scale SSIM: port of ``metrics_tpu/functional/image/ssim.py``.

The five window statistics (the means of ``x``, ``y``, ``x²``, ``y²`` and
``xy``) are one depthwise convolution over the five inputs stacked along the
batch, as in the JAX package. The variances are ``E[x²] - μ²``, which
cancels: float32 values agree with the JAX package to about 1e-5 on a
scalar and 1e-4 on a map, not bit for bit.
"""
import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.image.helper import (
    _avg_pool,
    _depthwise_conv,
    _gaussian_kernel_2d,
    _gaussian_kernel_3d,
    _reflection_pad,
)
from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.data import dtype_name
from metrics_tpu_torch.utilities.distributed import reduce


def _ssim_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Check dtypes and shapes: ``(B, C, H, W)`` or ``(B, C, D, H, W)``."""
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {dtype_name(preds.dtype)} and target: {dtype_name(target.dtype)}."
        )
    _check_same_shape(preds, target)
    if preds.ndim not in (4, 5):
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW or BxCxDxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    return preds, target


def _ssim_compute(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """The SSIM of each image (2-D or 3-D), reduced by ``reduction``."""
    is_3d = preds.ndim == 5
    n_spatial = 3 if is_3d else 2

    if not isinstance(kernel_size, Sequence):
        kernel_size = n_spatial * [kernel_size]
    if not isinstance(sigma, Sequence):
        sigma = n_spatial * [sigma]

    if len(kernel_size) != preds.ndim - 2 or len(kernel_size) not in (2, 3):
        raise ValueError(
            f"`kernel_size` has dimension {len(kernel_size)}, but expected to be two less than target dimensionality,"
            f" which is: {preds.ndim}"
        )
    if len(sigma) != preds.ndim - 2 or len(sigma) not in (2, 3):
        raise ValueError(
            f"`sigma` has dimension {len(sigma)}, but expected to be two less than target dimensionality,"
            f" which is: {preds.ndim}"
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    if data_range is None:
        # on the device: no value comes back to the host
        data_range = torch.maximum(preds.max() - preds.min(), target.max() - target.min())

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    channel = preds.shape[1]
    dtype = preds.dtype
    if gaussian_kernel:
        used_kernel_size = [int(3.5 * s + 0.5) * 2 + 1 for s in sigma]
    else:
        used_kernel_size = list(kernel_size)

    pads = [(k - 1) // 2 for k in used_kernel_size]
    spatial = tuple(preds.shape[2:])
    if any(dim < k for dim, k in zip(spatial, used_kernel_size)):
        # the map is cropped by the pad on each side, so a window larger than the image leaves an empty map
        # whose mean is NaN; the JAX package refuses it with this message
        raise ValueError(
            f"The effective SSIM window {used_kernel_size} cannot exceed the"
            f" spatial dimensions {spatial}; reduce `sigma` or"
            f" `kernel_size` (for multi-scale SSIM, each `betas` scale"
            f" halves the spatial dimensions, so fewer scales also help)."
        )
    preds_p = _reflection_pad(preds, pads)
    target_p = _reflection_pad(target, pads)

    if gaussian_kernel:
        make = _gaussian_kernel_3d if is_3d else _gaussian_kernel_2d
        kernel = make(channel, used_kernel_size, sigma, dtype, preds.device)
    else:
        kernel = torch.ones((channel, 1, *kernel_size), dtype=dtype, device=preds.device) / math.prod(kernel_size)

    # one grouped convolution over (5 * B, C, ...) computes all five statistics
    input_list = torch.cat((preds_p, target_p, preds_p * preds_p, target_p * target_p, preds_p * target_p))
    outputs = _depthwise_conv(input_list, kernel)
    mu_pred, mu_target, e_pred_sq, e_target_sq, e_pred_target = outputs.chunk(5)

    mu_pred_sq = mu_pred**2
    mu_target_sq = mu_target**2
    mu_pred_target = mu_pred * mu_target

    sigma_pred_sq = e_pred_sq - mu_pred_sq
    sigma_target_sq = e_target_sq - mu_target_sq
    sigma_pred_target = e_pred_target - mu_pred_target

    upper = 2 * sigma_pred_target + c2
    lower = sigma_pred_sq + sigma_target_sq + c2

    ssim_idx_full_image = ((2 * mu_pred_target + c1) * upper) / ((mu_pred_sq + mu_target_sq + c1) * lower)

    # the valid convolution of the padded image has the image's extent: crop the border that saw reflected pixels
    crops = tuple(slice(p, s - p) for p, s in zip(pads, ssim_idx_full_image.shape[2:]))
    ssim_idx = ssim_idx_full_image[(Ellipsis, *crops)]

    per_image = reduce(ssim_idx.reshape(ssim_idx.shape[0], -1).mean(-1), reduction)
    if return_contrast_sensitivity:
        contrast_sensitivity = (upper / lower)[(Ellipsis, *crops)]
        return per_image, reduce(contrast_sensitivity.reshape(contrast_sensitivity.shape[0], -1).mean(-1), reduction)
    if return_full_image:
        return per_image, reduce(ssim_idx_full_image, reduction)
    return per_image


def structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """SSIM of 2-D or 3-D images. A gaussian window's size follows from
    ``sigma`` (``2 * int(3.5 * sigma + 0.5) + 1``); ``kernel_size`` sizes the
    uniform window only.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import structural_similarity_index_measure
        >>> preds = torch.rand(8, 1, 16, 16, generator=torch.manual_seed(0))
        >>> target = preds * 0.75
        >>> float(structural_similarity_index_measure(preds, target)) > 0.9
        True
    """
    preds, target = _ssim_update(preds, target)
    return _ssim_compute(
        preds, target, gaussian_kernel, sigma, kernel_size, reduction, data_range, k1, k2,
        return_full_image, return_contrast_sensitivity,
    )


def _get_normalized_sim_and_cs(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    normalize: Optional[str] = None,
) -> Tuple[Tensor, Tensor]:
    sim, contrast_sensitivity = _ssim_compute(
        preds, target, gaussian_kernel, sigma, kernel_size, reduction, data_range, k1, k2,
        return_contrast_sensitivity=True,
    )
    if normalize == "relu":
        sim = torch.relu(sim)
        contrast_sensitivity = torch.relu(contrast_sensitivity)
    return sim, contrast_sensitivity


def _multiscale_ssim_compute(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = None,
) -> Tensor:
    """MS-SSIM: SSIM and contrast sensitivity at each scale, halving the
    images between scales. The size guards read ``kernel_size[0]`` for the
    height and ``[1]`` for the width, on 3-D input too."""
    sim_list: List[Tensor] = []
    cs_list: List[Tensor] = []

    if not isinstance(kernel_size, Sequence):
        kernel_size = (3 if preds.ndim == 5 else 2) * [kernel_size]

    if preds.shape[-1] < 2 ** len(betas) or preds.shape[-2] < 2 ** len(betas):
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)}, the image height and width dimensions must be"
            f" larger than or equal to {2 ** len(betas)}."
        )
    _betas_div = max(1, (len(betas) - 1)) ** 2
    if preds.shape[-2] // _betas_div <= kernel_size[0] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[0]},"
            f" the image height must be larger than {(kernel_size[0] - 1) * _betas_div}."
        )
    if preds.shape[-1] // _betas_div <= kernel_size[1] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[1]},"
            f" the image width must be larger than {(kernel_size[1] - 1) * _betas_div}."
        )

    for _ in range(len(betas)):
        sim, contrast_sensitivity = _get_normalized_sim_and_cs(
            preds, target, gaussian_kernel, sigma, kernel_size, reduction, data_range, k1, k2, normalize=normalize
        )
        sim_list.append(sim)
        cs_list.append(contrast_sensitivity)
        preds = _avg_pool(preds, 2)
        target = _avg_pool(target, 2)

    sim_stack = torch.stack(sim_list)
    cs_stack = torch.stack(cs_list)

    if normalize == "simple":
        sim_stack = (sim_stack + 1) / 2
        cs_stack = (cs_stack + 1) / 2

    # each scale to its beta as a float32 exponent (the JAX package's float32 array of betas, which also
    # promotes a bfloat16 stack): a Python exponent a scale, so nothing is copied from the host
    wide = torch.promote_types(sim_stack.dtype, torch.float32)
    sim_stack = torch.stack([s.to(wide) ** beta for s, beta in zip(sim_stack, betas)])
    cs_stack = torch.stack([c.to(wide) ** beta for c, beta in zip(cs_stack, betas)])
    if reduction is None or reduction == "none":
        cs_and_sim = torch.cat((cs_stack[:-1], sim_stack[-1:]), dim=0)
        return torch.prod(cs_and_sim, dim=0)
    return torch.prod(cs_stack[:-1]) * sim_stack[-1]


def multiscale_structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = "relu",
) -> Tensor:
    """Multi-scale SSIM over ``len(betas)`` scales.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import multiscale_structural_similarity_index_measure
        >>> preds = torch.rand(1, 1, 192, 192, generator=torch.manual_seed(42))
        >>> float(multiscale_structural_similarity_index_measure(preds, preds * 0.9, data_range=1.0)) > 0.99
        True
    """
    if not isinstance(betas, tuple):
        raise ValueError("Argument `betas` is expected to be of a type tuple")
    if isinstance(betas, tuple) and not all(isinstance(beta, float) for beta in betas):
        raise ValueError("Argument `betas` is expected to be a tuple of floats")
    if normalize and normalize not in ("relu", "simple"):
        raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")

    preds, target = _ssim_update(preds, target)
    return _multiscale_ssim_compute(
        preds, target, gaussian_kernel, sigma, kernel_size, reduction, data_range, k1, k2, betas, normalize
    )
