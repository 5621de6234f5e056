"""ERGAS: port of ``metrics_tpu/functional/image/ergas.py``."""
from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.data import dtype_name
from metrics_tpu_torch.utilities.distributed import reduce


def _ergas_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
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


def _ergas_compute(
    preds: Tensor,
    target: Tensor,
    ratio: Union[int, float] = 4,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """The band-wise RMSE relative to the band's mean, over the bands, a image."""
    b, c, h, w = preds.shape
    preds = preds.reshape(b, c, h * w)
    target = target.reshape(b, c, h * w)

    diff = preds - target
    sum_squared_error = torch.sum(diff * diff, dim=2)
    rmse_per_band = torch.sqrt(sum_squared_error / (h * w))
    mean_target = torch.mean(target, dim=2)

    ergas_score = 100 * ratio * torch.sqrt(torch.sum((rmse_per_band / mean_target) ** 2, dim=1) / c)
    return reduce(ergas_score, reduction)


def error_relative_global_dimensionless_synthesis(
    preds: Tensor,
    target: Tensor,
    ratio: Union[int, float] = 4,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """ERGAS of multispectral images; ``ratio`` is the high to low resolution ratio.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import error_relative_global_dimensionless_synthesis
        >>> preds = torch.rand(2, 3, 16, 16, generator=torch.manual_seed(42))
        >>> float(error_relative_global_dimensionless_synthesis(preds, preds * 0.9)) > 0
        True
    """
    preds, target = _ergas_update(preds, target)
    return _ergas_compute(preds, target, ratio, reduction)
