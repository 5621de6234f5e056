"""AUROC module metric: port of ``metrics_tpu/classification/auroc.py``.

The states are lists of the batches (``cat`` reduce); the curves are built
at ``compute``. With ``compute_on_cpu=True`` they move to the CPU after each
update, and ``compute`` runs there.
"""
from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.functional.classification.auroc import _auroc_compute, _auroc_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat
from metrics_tpu_torch.utilities.enums import AverageMethod, DataType


class AUROC(Metric):
    """Area under the receiver operating characteristic curve.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import AUROC
        >>> preds = torch.tensor([0.13, 0.26, 0.08, 0.19, 0.34])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> auroc = AUROC(pos_label=1, device="cpu")
        >>> float(auroc(preds, target))
        0.5
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    _aux_attributes = ("mode", "num_classes", "pos_label")

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        average: Optional[str] = "macro",
        max_fpr: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.pos_label = pos_label
        self.average = average
        self.max_fpr = max_fpr

        allowed_average = (AverageMethod.MACRO, AverageMethod.WEIGHTED, AverageMethod.NONE, AverageMethod.MICRO)
        if self.average not in (None, *allowed_average):
            raise ValueError(
                f"Argument `average` expected to be one of the following: {allowed_average} but got {average}"
            )
        if self.max_fpr is not None:
            if not isinstance(max_fpr, float) or not 0 < max_fpr <= 1:
                raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")

        self.mode: Optional[DataType] = None
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target, mode = _auroc_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

        if self.mode and self.mode != mode:
            raise ValueError(
                "The mode of data (binary, multi-label, multi-class) should be constant, but changed"
                f" between batches from {self.mode} to {mode}"
            )
        self.mode = mode

    def compute(self) -> Tensor:
        if not self.mode:
            raise RuntimeError("You have to have determined mode.")
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _auroc_compute(
            preds,
            target,
            self.mode,
            self.num_classes,
            self.pos_label,
            self.average,
            self.max_fpr,
        )
