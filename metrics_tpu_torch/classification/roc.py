"""ROC module metric: port of ``metrics_tpu/classification/roc.py``.

The states are lists of the canonicalised batches (``cat`` reduce); the
curves are built at ``compute``.
"""
from typing import Any, List, Optional, Tuple, Union

from torch import Tensor

from metrics_tpu_torch.functional.classification.roc import _roc_compute, _roc_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat


class ROC(Metric):
    """Receiver operating characteristic curve.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ROC
        >>> pred = torch.tensor([0.0, 1.0, 2.0, 3.0])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> roc = ROC(pos_label=1, device="cpu")
        >>> fpr, tpr, thresholds = roc(pred, target)
        >>> [round(float(x), 4) for x in fpr]
        [0.0, 0.0, 0.0, 0.0, 1.0]
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False
    _aux_attributes = ("num_classes", "pos_label")

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.pos_label = pos_label

        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target, num_classes, pos_label = _roc_update(preds, target, self.num_classes, self.pos_label)
        self.preds.append(preds)
        self.target.append(target)
        self.num_classes = num_classes
        self.pos_label = pos_label

    def compute(self) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        if not self.num_classes:
            raise ValueError(f"`num_classes` bas to be positive number, but got {self.num_classes}")
        return _roc_compute(preds, target, self.num_classes, self.pos_label)
