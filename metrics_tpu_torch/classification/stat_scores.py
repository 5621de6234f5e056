"""StatScores module metric: port of ``metrics_tpu/classification/stat_scores.py``.

State: tp/fp/tn/fn, int32 tensors with a sum reduce for the micro/macro
reduces; lists for ``reduce='samples'`` and ``mdmc_reduce='samplewise'``.
"""
from typing import Any, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.stat_scores import _stat_scores_compute, _stat_scores_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.enums import AverageMethod, MDMCAverageMethod


class StatScores(Metric):
    """Accumulate TP/FP/TN/FN counts.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import StatScores
        >>> m = StatScores(num_classes=3, reduce="micro", device="cpu")
        >>> m.update(torch.tensor([1, 0, 2, 1]), torch.tensor([1, 1, 2, 0]))
        >>> [int(v) for v in m.compute()]  # tp, fp, tn, fn, support
        [2, 2, 6, 2, 4]
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        threshold: float = 0.5,
        top_k: Optional[int] = None,
        reduce: str = "micro",
        num_classes: Optional[int] = None,
        ignore_index: Optional[int] = None,
        mdmc_reduce: Optional[str] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)

        self.reduce = reduce
        self.mdmc_reduce = mdmc_reduce
        self.num_classes = num_classes
        self.threshold = threshold
        self.multiclass = multiclass
        self.ignore_index = ignore_index
        self.top_k = top_k

        if reduce not in ["micro", "macro", "samples"]:
            raise ValueError(f"The `reduce` {reduce} is not valid.")
        if mdmc_reduce not in [None, "samplewise", "global"]:
            raise ValueError(f"The `mdmc_reduce` {mdmc_reduce} is not valid.")
        if reduce == "macro" and (not num_classes or num_classes < 1):
            raise ValueError("When you set `reduce` as 'macro', you have to provide the number of classes.")
        if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
            raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")

        if mdmc_reduce != "samplewise" and reduce != "samples":
            shape = () if reduce == "micro" else (num_classes,)
            for s in ("tp", "fp", "tn", "fn"):
                self.add_state(s, default=torch.zeros(shape, dtype=torch.int32), dist_reduce_fx="sum")
        else:
            for s in ("tp", "fp", "tn", "fn"):
                self.add_state(s, default=[], dist_reduce_fx="cat")

    def _accumulate(self, tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> None:
        if self.reduce != AverageMethod.SAMPLES and self.mdmc_reduce != MDMCAverageMethod.SAMPLEWISE:
            self.tp = self.tp + tp
            self.fp = self.fp + fp
            self.tn = self.tn + tn
            self.fn = self.fn + fn
        else:
            self.tp.append(tp)
            self.fp.append(fp)
            self.tn.append(tn)
            self.fn.append(fn)

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate the stat scores of a batch."""
        self._accumulate(
            *_stat_scores_update(
                preds,
                target,
                reduce=self.reduce,
                mdmc_reduce=self.mdmc_reduce,
                threshold=self.threshold,
                num_classes=self.num_classes,
                top_k=self.top_k,
                multiclass=self.multiclass,
                ignore_index=self.ignore_index,
            )
        )

    # the fast-dispatch engine's padded batches (metrics_tpu/classification/stat_scores.py:109-131)
    def _masked_update_supported(self) -> bool:
        # the collapsing reduces make masked rows exact no-ops; the per-sample ones keep a row an input
        return self.reduce in ("micro", "macro") and self.mdmc_reduce != MDMCAverageMethod.SAMPLEWISE

    def _masked_update(self, sample_mask: Tensor, preds: Tensor, target: Tensor) -> None:
        """``update`` with a dim-0 validity mask (padded rows count zero)."""
        tp, fp, tn, fn = _stat_scores_update(
            preds,
            target,
            reduce=self.reduce,
            mdmc_reduce=self.mdmc_reduce,
            threshold=self.threshold,
            num_classes=self.num_classes,
            top_k=self.top_k,
            multiclass=self.multiclass,
            ignore_index=self.ignore_index,
            sample_mask=sample_mask,
        )
        self.tp = self.tp + tp
        self.fp = self.fp + fp
        self.tn = self.tn + tn
        self.fn = self.fn + fn

    def _get_final_stats(self) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        """Concatenate list states where needed."""
        tp = torch.cat(self.tp) if isinstance(self.tp, list) else self.tp
        fp = torch.cat(self.fp) if isinstance(self.fp, list) else self.fp
        tn = torch.cat(self.tn) if isinstance(self.tn, list) else self.tn
        fn = torch.cat(self.fn) if isinstance(self.fn, list) else self.fn
        return tp, fp, tn, fn

    def compute(self) -> Tensor:
        """``[..., 5]`` tensor of tp/fp/tn/fn/support."""
        return _stat_scores_compute(*self._get_final_stats())
