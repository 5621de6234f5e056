"""UniversalImageQualityIndex module metric: port of ``metrics_tpu/image/uqi.py``."""
from typing import Any, Optional, Sequence

from torch import Tensor

from metrics_tpu_torch.functional.image.uqi import _uqi_compute, _uqi_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat


class UniversalImageQualityIndex(Metric):
    """UQI over the accumulated image batches (list states, ``cat``).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import UniversalImageQualityIndex
        >>> preds = torch.rand(2, 3, 16, 16, generator=torch.manual_seed(42))
        >>> m = UniversalImageQualityIndex(device="cpu")
        >>> m.update(preds, preds * 0.9)
        >>> float(m.compute()) > 0.98
        True
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.reduction = reduction
        self.data_range = data_range

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _uqi_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _uqi_compute(preds, target, self.kernel_size, self.sigma, self.reduction, self.data_range)
