"""ConfusionMatrix module metric: port of ``metrics_tpu/classification/confusion_matrix.py``.

State: one int32 ``(C, C)`` matrix (``(C, 2, 2)`` multilabel) with a sum reduce.
"""
from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _confusion_matrix_compute,
    _confusion_matrix_update,
    _confusion_matrix_update_matmul,
)
from metrics_tpu_torch.metric import Metric


def _validate_update_method(update_method: str) -> None:
    if update_method not in ("bincount", "matmul"):
        raise ValueError(f"Argument `update_method` must be 'bincount' or 'matmul', got {update_method}")


class ConfusionMatrix(Metric):
    """Confusion matrix accumulated over batches.

    ``update_method="bincount"`` (the default) counts with ``torch.bincount``;
    ``"matmul"`` (the JAX package's one-hot product) counts with the
    ``confusion_matrix`` kernel. Both give the same counts.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ConfusionMatrix
        >>> confmat = ConfusionMatrix(num_classes=2, device="cpu")
        >>> confmat(torch.tensor([0, 1, 0, 0]), torch.tensor([1, 1, 0, 0]))
        tensor([[2, 0],
                [1, 1]], dtype=torch.int32)
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        normalize: Optional[str] = None,
        threshold: float = 0.5,
        multilabel: bool = False,
        update_method: str = "bincount",
        shard_state: Any = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.normalize = normalize
        self.threshold = threshold
        self.multilabel = multilabel

        allowed_normalize = ("true", "pred", "all", "none", None)
        if normalize not in allowed_normalize:
            raise ValueError(f"Argument average needs to one of the following: {allowed_normalize}")
        _validate_update_method(update_method)
        if update_method == "matmul" and multilabel:
            raise ValueError("`update_method='matmul'` does not support `multilabel=True`")
        self.update_method = update_method

        shape = (num_classes, 2, 2) if multilabel else (num_classes, num_classes)
        # shard_state places the (C, ...) row axis over a process group: pure_sync over it is one reduce-scatter
        # and leaves each rank C/N rows, an O(C^2 / N) state a rank
        self.add_state("confmat", default=torch.zeros(shape, dtype=torch.int32), dist_reduce_fx="sum",
                       shard_state=shard_state)

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.update_method == "matmul":
            confmat = _confusion_matrix_update_matmul(preds, target, self.num_classes, self.threshold)
        else:
            confmat = _confusion_matrix_update(preds, target, self.num_classes, self.threshold, self.multilabel)
        self.confmat = self.confmat + confmat

    def compute(self) -> Tensor:
        return _confusion_matrix_compute(self.confmat, self.normalize)
