"""AveragePrecision module metric: port of ``metrics_tpu/classification/avg_precision.py``.

The states are lists of the canonicalised batches (``cat`` reduce); the
curve is built at ``compute``. For a constant-memory alternative on the
``binned_stats`` kernel use
:class:`~metrics_tpu_torch.classification.BinnedAveragePrecision`.
"""
from typing import Any, List, Optional, Union

from torch import Tensor

from metrics_tpu_torch.functional.classification.average_precision import (
    _average_precision_compute,
    _average_precision_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat


class AveragePrecision(Metric):
    """Average precision score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import AveragePrecision
        >>> pred = torch.tensor([0.0, 1.0, 2.0, 3.0])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> average_precision = AveragePrecision(pos_label=1, device="cpu")
        >>> float(average_precision(pred, target))
        1.0
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False
    _aux_attributes = ("num_classes", "pos_label")

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        average: Optional[str] = "macro",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.pos_label = pos_label
        allowed_average = ("micro", "macro", "weighted", "none", None)
        if average not in allowed_average:
            raise ValueError(f"Expected argument `average` to be one of {allowed_average}" f" but got {average}")
        self.average = average

        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target, num_classes, pos_label = _average_precision_update(
            preds, target, self.num_classes, self.pos_label, self.average
        )
        self.preds.append(preds)
        self.target.append(target)
        self.num_classes = num_classes
        self.pos_label = pos_label

    def compute(self) -> Union[Tensor, List[Tensor]]:
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _average_precision_compute(preds, target, self.num_classes, self.pos_label, self.average)
