"""Retrieval module metrics with batched multi-query computes.

Port of ``metrics_tpu/retrieval/metrics.py``. Each ``_metric_batched``
scores every query of the padded ``(Q, L)`` matrix in one pass whose ranking
step is one ``retrieval_sort`` launch.
"""
from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.retrieval.metrics import (
    _first_true,
    retrieval_average_precision,
    retrieval_fall_out,
    retrieval_hit_rate,
    retrieval_normalized_dcg,
    retrieval_precision,
    retrieval_r_precision,
    retrieval_recall,
    retrieval_reciprocal_rank,
)
from metrics_tpu_torch.ops import sorted_by_preds
from metrics_tpu_torch.retrieval.base import RetrievalMetric


def _arange(n: int, like: Tensor, dtype: Optional[torch.dtype] = None) -> Tensor:
    return torch.arange(n, dtype=dtype, device=like.device)


class RetrievalMAP(RetrievalMetric):
    """Mean Average Precision over queries.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalMAP
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> rmap = RetrievalMAP(device="cpu")
        >>> round(float(rmap(preds, target, indexes)), 4)
        0.7917
    """

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_average_precision(preds, target)

    def _metric_batched(self, padded_preds: Tensor, padded_target: Tensor, valid: Tensor) -> Tensor:
        rel = sorted_by_preds(padded_preds, padded_target > 0)
        positions = _arange(padded_preds.shape[1], rel, torch.float32) + 1.0
        prec = torch.cumsum(rel, dim=1) / positions
        n_rel = rel.sum(dim=1)
        return torch.where(n_rel > 0, (prec * rel).sum(dim=1) / n_rel.clamp(min=1), 0.0)


class RetrievalMRR(RetrievalMetric):
    """Mean Reciprocal Rank.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalMRR
        >>> m = RetrievalMRR(device="cpu")
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> m.update(preds, target, indexes=torch.tensor([0, 0, 0, 1, 1, 1, 1]))
        >>> round(float(m.compute()), 4)
        1.0
    """

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_reciprocal_rank(preds, target)

    def _metric_batched(self, padded_preds: Tensor, padded_target: Tensor, valid: Tensor) -> Tensor:
        rel = sorted_by_preds(padded_preds, padded_target > 0)
        first = _first_true(rel, dim=1)
        return torch.where(rel.any(dim=1), 1.0 / (first + 1.0), 0.0)


class _TopKRetrievalMetric(RetrievalMetric):
    """Shared constructor of the metrics with a top-k cutoff."""

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        k: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        if (k is not None) and not (isinstance(k, int) and k > 0):
            raise ValueError("`k` has to be a positive integer or None")
        self.k = k

    def _cutoff(self, padded_preds: Tensor) -> int:
        return padded_preds.shape[1] if self.k is None else self.k


class RetrievalPrecision(_TopKRetrievalMetric):
    """Precision@k averaged over queries.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalPrecision
        >>> m = RetrievalPrecision(k=2, device="cpu")
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> m.update(preds, target, indexes=torch.tensor([0, 0, 0, 1, 1, 1, 1]))
        >>> round(float(m.compute()), 4)
        0.5
    """

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        k: Optional[int] = None,
        adaptive_k: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, k=k, **kwargs)
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.adaptive_k = adaptive_k

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_precision(preds, target, k=self.k, adaptive_k=self.adaptive_k)

    def _metric_batched(self, padded_preds: Tensor, padded_target: Tensor, valid: Tensor) -> Tensor:
        rel = sorted_by_preds(padded_preds, padded_target > 0)
        group_sizes = valid.sum(dim=1)
        if self.k is None:
            kq = group_sizes  # k defaults to each query's document count
        elif self.adaptive_k:
            kq = group_sizes.clamp(max=self.k)
        else:
            kq = torch.full_like(group_sizes, self.k)
        in_k = _arange(padded_preds.shape[1], rel)[None, :] < kq[:, None]
        hits = (rel & in_k).sum(dim=1).to(torch.float32)
        return torch.where((padded_target > 0).sum(dim=1) > 0, hits / kq, 0.0)


class RetrievalRecall(_TopKRetrievalMetric):
    """Recall@k averaged over queries.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalRecall
        >>> m = RetrievalRecall(k=2, device="cpu")
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> m.update(preds, target, indexes=torch.tensor([0, 0, 0, 1, 1, 1, 1]))
        >>> round(float(m.compute()), 4)
        0.75
    """

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_recall(preds, target, k=self.k)

    def _metric_batched(self, padded_preds: Tensor, padded_target: Tensor, valid: Tensor) -> Tensor:
        rel = sorted_by_preds(padded_preds, padded_target > 0)
        hits = rel[:, : self._cutoff(padded_preds)].sum(dim=1).to(torch.float32)
        n_rel = rel.sum(dim=1)
        return torch.where(n_rel > 0, hits / n_rel.clamp(min=1), 0.0)


class RetrievalHitRate(_TopKRetrievalMetric):
    """HitRate@k averaged over queries.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalHitRate
        >>> m = RetrievalHitRate(k=2, device="cpu")
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> m.update(preds, target, indexes=torch.tensor([0, 0, 0, 1, 1, 1, 1]))
        >>> round(float(m.compute()), 4)
        1.0
    """

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_hit_rate(preds, target, k=self.k)

    def _metric_batched(self, padded_preds: Tensor, padded_target: Tensor, valid: Tensor) -> Tensor:
        rel = sorted_by_preds(padded_preds, padded_target > 0)
        return (rel[:, : self._cutoff(padded_preds)].sum(dim=1) > 0).to(torch.float32)


class RetrievalFallOut(_TopKRetrievalMetric):
    """FallOut@k averaged over queries; a query is empty when it has no
    non-relevant document.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalFallOut
        >>> m = RetrievalFallOut(k=2, device="cpu")
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> m.update(preds, target, indexes=torch.tensor([0, 0, 0, 1, 1, 1, 1]))
        >>> round(float(m.compute()), 4)
        0.5
    """

    higher_is_better = False

    def __init__(
        self,
        empty_target_action: str = "pos",
        ignore_index: Optional[int] = None,
        k: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, k=k, **kwargs)

    def _empty_query_mask(self, padded_target: Tensor, valid: Tensor) -> Tensor:
        return ((padded_target == 0) & valid).sum(dim=1) == 0

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_fall_out(preds, target, k=self.k)

    def _metric_batched(self, padded_preds: Tensor, padded_target: Tensor, valid: Tensor) -> Tensor:
        nonrel = sorted_by_preds(padded_preds, (padded_target == 0) & valid)
        hits = nonrel[:, : self._cutoff(padded_preds)].sum(dim=1).to(torch.float32)
        n_nonrel = nonrel.sum(dim=1)
        return torch.where(n_nonrel > 0, hits / n_nonrel.clamp(min=1), 0.0)


class RetrievalNormalizedDCG(_TopKRetrievalMetric):
    """nDCG@k averaged over queries (graded relevance allowed).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalNormalizedDCG
        >>> m = RetrievalNormalizedDCG(device="cpu")
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> m.update(preds, target, indexes=torch.tensor([0, 0, 0, 1, 1, 1, 1]))
        >>> round(float(m.compute()), 4)
        0.9599
    """

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        k: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, k=k, **kwargs)
        self.allow_non_binary_target = True

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_normalized_dcg(preds, target, k=self.k)

    def _metric_batched(self, padded_preds: Tensor, padded_target: Tensor, valid: Tensor) -> Tensor:
        target_f = padded_target.to(torch.float32) * valid
        sorted_target = sorted_by_preds(padded_preds, target_f)
        max_len = padded_preds.shape[1]
        denom = torch.log2(_arange(max_len, target_f, torch.float32) + 2.0)
        in_k = _arange(max_len, target_f) < self._cutoff(padded_preds)
        dcg = (sorted_target / denom * in_k).sum(dim=1)
        # pads must sort below any real grade (grades may be negative): -inf
        # for the ideal order, then zero; a plain value sort, not the kernel
        ideal = torch.sort(torch.where(valid, target_f, -float("inf")), dim=1, descending=True).values
        ideal = torch.where(torch.isfinite(ideal), ideal, 0.0)
        idcg = (ideal / denom * in_k).sum(dim=1)
        return torch.where(idcg > 0, dcg / idcg.clamp(min=1e-12), 0.0)


class RetrievalRPrecision(RetrievalMetric):
    """R-precision averaged over queries.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalRPrecision
        >>> m = RetrievalRPrecision(device="cpu")
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> m.update(preds, target, indexes=torch.tensor([0, 0, 0, 1, 1, 1, 1]))
        >>> round(float(m.compute()), 4)
        0.75
    """

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_r_precision(preds, target)

    def _metric_batched(self, padded_preds: Tensor, padded_target: Tensor, valid: Tensor) -> Tensor:
        rel = sorted_by_preds(padded_preds, padded_target > 0)
        n_rel = rel.sum(dim=1)
        in_r = _arange(padded_preds.shape[1], rel)[None, :] < n_rel[:, None]
        hits = (rel & in_r).sum(dim=1).to(torch.float32)
        return torch.where(n_rel > 0, hits / n_rel.clamp(min=1), 0.0)
