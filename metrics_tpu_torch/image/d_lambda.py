"""SpectralDistortionIndex module metric: port of ``metrics_tpu/image/d_lambda.py``."""
from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.functional.image.d_lambda import (
    _spectral_distortion_index_compute,
    _spectral_distortion_index_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat


class SpectralDistortionIndex(Metric):
    """D-lambda over the accumulated image batches (list states, ``cat``).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SpectralDistortionIndex
        >>> preds = torch.rand(2, 3, 16, 16, generator=torch.manual_seed(42))
        >>> m = SpectralDistortionIndex(device="cpu")
        >>> m.update(preds, preds * 0.9)
        >>> round(float(m.compute()), 4)
        0.0
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, p: int = 1, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(p, int) or p <= 0:
            raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
        self.p = p
        allowed_reductions = ("elementwise_mean", "sum", "none")
        if reduction not in allowed_reductions:
            raise ValueError(f"Expected argument `reduction` be one of {allowed_reductions} but got {reduction}")
        self.reduction = reduction
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _spectral_distortion_index_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _spectral_distortion_index_compute(preds, target, self.p, self.reduction)
