"""CohenKappa module metric: port of ``metrics_tpu/classification/cohen_kappa.py``."""
from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.confusion_matrix import ConfusionMatrix
from metrics_tpu_torch.functional.classification.cohen_kappa import _cohen_kappa_compute


class CohenKappa(ConfusionMatrix):
    """Cohen's kappa accumulated over batches; ``update_method="matmul"``
    counts with the ``confusion_matrix`` kernel.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CohenKappa
        >>> cohenkappa = CohenKappa(num_classes=2, device="cpu")
        >>> float(cohenkappa(torch.tensor([0, 1, 0, 0]), torch.tensor([1, 1, 0, 0])))
        0.5
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        weights: Optional[str] = None,
        threshold: float = 0.5,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes=num_classes, normalize=None, threshold=threshold, **kwargs)
        self.weights = weights
        allowed_weights = (None, "none", "linear", "quadratic")
        if weights not in allowed_weights:
            raise ValueError(f"Argument weights needs to one of the following: {allowed_weights}")

    def compute(self) -> Tensor:
        return _cohen_kappa_compute(self.confmat, self.weights)
