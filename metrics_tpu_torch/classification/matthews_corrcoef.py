"""MatthewsCorrCoef module metric: port of ``metrics_tpu/classification/matthews_corrcoef.py``."""
from typing import Any

import torch
from torch import Tensor

from metrics_tpu_torch.classification.confusion_matrix import _validate_update_method
from metrics_tpu_torch.functional.classification.confusion_matrix import _confusion_matrix_update_matmul
from metrics_tpu_torch.functional.classification.matthews_corrcoef import (
    _matthews_corrcoef_compute,
    _matthews_corrcoef_update,
)
from metrics_tpu_torch.metric import Metric


class MatthewsCorrCoef(Metric):
    """Matthews correlation coefficient accumulated over batches;
    ``update_method="matmul"`` counts with the ``confusion_matrix`` kernel.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MatthewsCorrCoef
        >>> matthews_corrcoef = MatthewsCorrCoef(num_classes=2, device="cpu")
        >>> round(float(matthews_corrcoef(torch.tensor([0, 1, 0, 0]), torch.tensor([1, 1, 0, 0]))), 4)
        0.5774
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        threshold: float = 0.5,
        update_method: str = "bincount",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.threshold = threshold
        _validate_update_method(update_method)
        self.update_method = update_method
        self.add_state("confmat", default=torch.zeros((num_classes, num_classes), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.update_method == "matmul":
            confmat = _confusion_matrix_update_matmul(preds, target, self.num_classes, self.threshold)
        else:
            confmat = _matthews_corrcoef_update(preds, target, self.num_classes, self.threshold)
        self.confmat = self.confmat + confmat

    def compute(self) -> Tensor:
        return _matthews_corrcoef_compute(self.confmat)
