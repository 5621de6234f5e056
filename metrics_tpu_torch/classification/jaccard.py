"""JaccardIndex module metric: port of ``metrics_tpu/classification/jaccard.py``."""
from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.confusion_matrix import ConfusionMatrix
from metrics_tpu_torch.functional.classification.jaccard import _jaccard_from_confmat


class JaccardIndex(ConfusionMatrix):
    """Jaccard index (intersection over union) accumulated over batches;
    ``update_method="matmul"`` counts with the ``confusion_matrix`` kernel.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import JaccardIndex
        >>> jaccard = JaccardIndex(num_classes=2, device="cpu")
        >>> target = torch.tensor([[0, 1, 1], [1, 1, 0]])
        >>> pred = torch.tensor([[0, 1, 0], [1, 1, 1]])
        >>> round(float(jaccard(pred, target)), 4)
        0.4667
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        ignore_index: Optional[int] = None,
        absent_score: float = 0.0,
        threshold: float = 0.5,
        multilabel: bool = False,
        reduction: Optional[str] = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes=num_classes, normalize=None, threshold=threshold, multilabel=multilabel, **kwargs)
        self.reduction = reduction
        self.ignore_index = ignore_index
        self.absent_score = absent_score

    def compute(self) -> Tensor:
        return _jaccard_from_confmat(self.confmat, self.num_classes, self.ignore_index, self.absent_score, self.reduction)
