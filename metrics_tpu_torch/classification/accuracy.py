"""Accuracy module metric: port of ``metrics_tpu/classification/accuracy.py``."""
from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.stat_scores import StatScores
from metrics_tpu_torch.functional.classification.accuracy import (
    _accuracy_compute,
    _accuracy_update,
    _check_subset_validity,
    _mode,
    _subset_accuracy_compute,
    _subset_accuracy_update,
)
from metrics_tpu_torch.utilities.enums import DataType


class Accuracy(StatScores):
    """Accuracy over any classification input type.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> accuracy = Accuracy(device="cpu")
        >>> float(accuracy(torch.tensor([0, 2, 1, 3]), torch.tensor([0, 1, 2, 3])))
        0.5
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    _aux_attributes = ("mode", "subset_accuracy")

    def __init__(
        self,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        average: Optional[str] = "micro",
        mdmc_average: Optional[str] = "global",
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        subset_accuracy: bool = False,
        **kwargs: Any,
    ) -> None:
        allowed_average = ["micro", "macro", "weighted", "samples", "none", None]
        if average not in allowed_average:
            raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")

        super().__init__(
            reduce="macro" if average in ["weighted", "none", None] else average,
            mdmc_reduce=mdmc_average,
            threshold=threshold,
            top_k=top_k,
            num_classes=num_classes,
            multiclass=multiclass,
            ignore_index=ignore_index,
            **kwargs,
        )

        if top_k is not None and (not isinstance(top_k, int) or top_k <= 0):
            raise ValueError(f"The `top_k` should be an integer larger than 0, got {top_k}")

        self.average = average
        self.subset_accuracy = subset_accuracy
        self.mode: Optional[DataType] = None  # checkpointed through _aux_attributes

        if self.subset_accuracy:
            self.add_state("correct", default=0, dist_reduce_fx="sum")
            self.add_state("total", default=0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Detect the input mode (running the input checks) and accumulate."""
        mode = _mode(preds, target, self.threshold, self.top_k, self.num_classes, self.multiclass, self.ignore_index)

        if not self.mode:
            self.mode = mode
        elif self.mode != mode:
            raise ValueError(f"You can not use {mode} inputs with {self.mode} inputs.")

        if self.subset_accuracy and not _check_subset_validity(self.mode):
            self.subset_accuracy = False

        if self.subset_accuracy:
            correct, total = _subset_accuracy_update(
                preds, target, threshold=self.threshold, top_k=self.top_k, ignore_index=self.ignore_index
            )
            self.correct = self.correct + correct
            self.total = self.total + total
        else:
            self._accumulate(
                *_accuracy_update(
                    preds,
                    target,
                    reduce=self.reduce,
                    mdmc_reduce=self.mdmc_reduce,
                    threshold=self.threshold,
                    num_classes=self.num_classes,
                    top_k=self.top_k,
                    multiclass=self.multiclass,
                    ignore_index=self.ignore_index,
                    mode=self.mode,
                )
            )

    # the fast-dispatch engine's padded batches (metrics_tpu/classification/accuracy.py:128-155)
    def _masked_update_supported(self) -> bool:
        return not self.subset_accuracy and super()._masked_update_supported()

    def _masked_update(self, sample_mask: Tensor, preds: Tensor, target: Tensor) -> None:
        """``update`` with a dim-0 validity mask (padded rows count zero)."""
        mode = _mode(preds, target, self.threshold, self.top_k, self.num_classes, self.multiclass, self.ignore_index)
        if not self.mode:
            self.mode = mode
        elif self.mode != mode:
            raise ValueError(f"You can not use {mode} inputs with {self.mode} inputs.")
        tp, fp, tn, fn = _accuracy_update(
            preds,
            target,
            reduce=self.reduce,
            mdmc_reduce=self.mdmc_reduce,
            threshold=self.threshold,
            num_classes=self.num_classes,
            top_k=self.top_k,
            multiclass=self.multiclass,
            ignore_index=self.ignore_index,
            mode=self.mode,
            sample_mask=sample_mask,
        )
        self.tp = self.tp + tp
        self.fp = self.fp + fp
        self.tn = self.tn + tn
        self.fn = self.fn + fn

    def _stacked_mode(self, preds: Tensor, target: Tensor) -> DataType:
        # the mode bookkeeping of _masked_update: the first batch fixes it, a later one must agree
        mode = _mode(preds, target, self.threshold, self.top_k, self.num_classes, self.multiclass, self.ignore_index)
        if not self.mode:
            self.mode = mode
        elif self.mode != mode:
            raise ValueError(f"You can not use {mode} inputs with {self.mode} inputs.")
        return mode

    def compute(self) -> Tensor:
        """Accuracy from the accumulated state."""
        if not self.mode:
            raise RuntimeError("You have to have determined mode.")
        if self.subset_accuracy:
            return _subset_accuracy_compute(self.correct, self.total)
        tp, fp, tn, fn = self._get_final_stats()
        return _accuracy_compute(tp, fp, tn, fn, self.average, self.mdmc_reduce, self.mode)


Accuracy._stacked_update_of = Accuracy._masked_update
