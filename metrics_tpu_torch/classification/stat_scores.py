"""StatScores module metric: port of ``metrics_tpu/classification/stat_scores.py``.

State: tp/fp/tn/fn, int32 tensors with a sum reduce for the micro/macro
reduces; lists for ``reduce='samples'`` and ``mdmc_reduce='samplewise'``.
"""
from typing import Any, Dict, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.stat_scores import (
    _fast_multiclass_eligible,
    _fast_multiclass_stat_scores,
    _stat_scores_compute,
    _stat_scores_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.checks import _check_classification_inputs
from metrics_tpu_torch.utilities.enums import AverageMethod, DataType, MDMCAverageMethod


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

    # the multi-tenant service's stacked update (metrics_tpu_torch/serve.py): one launch for S sessions
    def _stacked_masked_update(
        self, rows: Dict[str, Tensor], sample_mask: Tensor, preds: Tensor, target: Tensor
    ) -> Optional[Dict[str, Tensor]]:
        """S sessions' :meth:`_masked_update` at once: ``rows`` holds each
        state leaf with a leading session axis, ``sample_mask`` is ``(S, B)``,
        ``preds`` ``(S, B, C)`` float scores and ``target`` ``(S, B)`` labels.
        Returns the new rows, each session's equal to its own masked update;
        ``None`` where the inputs or the configuration take another path than
        :func:`_fast_multiclass_stat_scores` (the caller then updates the
        sessions one by one). Decided from shapes, dtypes and the
        configuration alone: no value is read from the device."""
        if type(self)._masked_update is not type(self)._stacked_update_of:
            return None  # a subclass whose masked update this hook does not mirror
        if not self._masked_update_supported() or preds.ndim != 3 or target.ndim != 2:
            return None
        lane_preds, lane_target = preds[0], target[0]
        if self.ignore_index is not None and not 0 <= self.ignore_index < preds.shape[-1]:
            return None
        if not _fast_multiclass_eligible(lane_preds, lane_target, self.reduce, self.top_k, self.multiclass,
                                         self.num_classes):
            return None
        if self._stacked_mode(lane_preds, lane_target) != DataType.MULTICLASS:
            return None
        counts = _fast_multiclass_stat_scores(preds, target, self.reduce, self.ignore_index, sample_mask)
        return {k: rows[k] + v for k, v in zip(("tp", "fp", "tn", "fn"), counts)}

    def _stacked_mode(self, preds: Tensor, target: Tensor) -> DataType:
        """The input case of one session's batch, as :meth:`_masked_update`'s
        formatting finds it (its checks run: shapes only, under an engine)."""
        return _check_classification_inputs(
            preds, target, threshold=self.threshold, num_classes=self.num_classes, multiclass=self.multiclass,
            top_k=self.top_k, ignore_index=self.ignore_index,
        )

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


# the masked update that _stacked_masked_update mirrors, for this class and the subclasses that keep it
StatScores._stacked_update_of = StatScores._masked_update
