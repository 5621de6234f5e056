"""AUC module metric: port of ``metrics_tpu/classification/auc.py``."""
from typing import Any

from torch import Tensor

from metrics_tpu_torch.functional.classification.auc import _auc_compute, _auc_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat


class AUC(Metric):
    """Area under the curve of the ``(x, y)`` pairs accumulated over updates.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import AUC
        >>> m = AUC(device="cpu")
        >>> m.update(torch.tensor([0.0, 0.5, 1.0]), torch.tensor([0.0, 0.8, 1.0]))
        >>> round(float(m.compute()), 4)
        0.65
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(self, reorder: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.reorder = reorder
        self.add_state("x", default=[], dist_reduce_fx="cat")
        self.add_state("y", default=[], dist_reduce_fx="cat")

    def update(self, x: Tensor, y: Tensor) -> None:
        x, y = _auc_update(x, y)
        self.x.append(x)
        self.y.append(y)

    def compute(self) -> Tensor:
        x = dim_zero_cat(self.x)
        y = dim_zero_cat(self.y)
        return _auc_compute(x, y, reorder=self.reorder)
