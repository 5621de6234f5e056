"""Spectral angle mapper: port of ``metrics_tpu/functional/image/sam.py``.

Near zero angles ``arccos`` amplifies the last bit of the cosine: there the
angle agrees with the JAX package to about 1e-3, not to a relative tolerance.
"""
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.data import dtype_name
from metrics_tpu_torch.utilities.distributed import reduce


def _sam_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Check dtypes, shapes (``(B, C, H, W)``) and at least two bands."""
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
    if (preds.shape[1] <= 1) or (target.shape[1] <= 1):
        raise ValueError(
            "Expected channel dimension of `preds` and `target` to be larger than 1."
            f" Got preds: {preds.shape[1]} and target: {target.shape[1]}."
        )
    return preds, target


def _sam_compute(
    preds: Tensor,
    target: Tensor,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """The angle between the spectral vectors of each pixel."""
    dot_product = (preds * target).sum(dim=1)
    preds_norm = torch.linalg.vector_norm(preds, dim=1)
    target_norm = torch.linalg.vector_norm(target, dim=1)
    sam_score = torch.arccos(torch.clamp(dot_product / (preds_norm * target_norm), -1, 1))
    return reduce(sam_score, reduction)


def spectral_angle_mapper(
    preds: Tensor,
    target: Tensor,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """SAM in radians, a pixel, reduced by ``reduction``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import spectral_angle_mapper
        >>> preds = torch.rand(8, 3, 16, 16, generator=torch.manual_seed(42))
        >>> target = torch.rand(8, 3, 16, 16, generator=torch.manual_seed(123))
        >>> 0.0 < float(spectral_angle_mapper(preds, target)) < 1.6
        True
    """
    preds, target = _sam_update(preds, target)
    return _sam_compute(preds, target, reduction)
