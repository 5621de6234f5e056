"""ErrorRelativeGlobalDimensionlessSynthesis module metric: port of ``metrics_tpu/image/ergas.py``."""
from typing import Any, Optional, Union

from torch import Tensor

from metrics_tpu_torch.functional.image.ergas import _ergas_compute, _ergas_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat


class ErrorRelativeGlobalDimensionlessSynthesis(Metric):
    """ERGAS over the accumulated image batches (list states, ``cat``).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ErrorRelativeGlobalDimensionlessSynthesis
        >>> preds = torch.rand(2, 3, 16, 16, generator=torch.manual_seed(42))
        >>> m = ErrorRelativeGlobalDimensionlessSynthesis(device="cpu")
        >>> m.update(preds, preds * 0.9)
        >>> float(m.compute()) > 0
        True
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        ratio: Union[int, float] = 4,
        reduction: Optional[str] = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")
        self.ratio = ratio
        self.reduction = reduction

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _ergas_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _ergas_compute(preds, target, self.ratio, self.reduction)
