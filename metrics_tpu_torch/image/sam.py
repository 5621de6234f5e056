"""SpectralAngleMapper module metric: port of ``metrics_tpu/image/sam.py``."""
from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.functional.image.sam import _sam_compute, _sam_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat


class SpectralAngleMapper(Metric):
    """SAM over the accumulated image batches (list states, ``cat``).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SpectralAngleMapper
        >>> preds = torch.rand(2, 3, 16, 16, generator=torch.manual_seed(42))
        >>> m = SpectralAngleMapper(device="cpu")
        >>> m.update(preds, preds * 0.9)
        >>> float(m.compute()) < 0.01
        True
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")
        self.reduction = reduction

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _sam_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _sam_compute(preds, target, self.reduction)
