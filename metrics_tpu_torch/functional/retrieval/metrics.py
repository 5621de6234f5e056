"""Per-query retrieval metrics (one query -> scalar).

Port of ``metrics_tpu/functional/retrieval/metrics.py``. Every metric here
starts from the same grouping step, relevance labels reordered by
descending score (:func:`metrics_tpu_torch.ops.sorted_by_preds`): on a CUDA
tensor one launch of the ``retrieval_sort`` kernel per call. The module
metrics (:mod:`metrics_tpu_torch.retrieval`) score all queries at once on a
padded ``(Q, L)`` matrix instead.
"""
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.ops import sorted_by_preds
from metrics_tpu_torch.utilities.checks import _check_retrieval_functional_inputs


def _first_true(x: Tensor, dim: int = -1) -> Tensor:
    """Index of the first True along ``dim`` (0 where there is none), as
    ``jnp.argmax`` on bool gives it."""
    return torch.argmax(x.to(torch.uint8), dim=dim)


def retrieval_average_precision(preds: Tensor, target: Tensor) -> Tensor:
    """AP over one query.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_average_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> round(float(retrieval_average_precision(preds, target)), 4)
        0.8333
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    rel = sorted_by_preds(preds, target) > 0
    positions = torch.arange(1, target.shape[0] + 1, dtype=torch.float32, device=preds.device)
    prec_at_rel = torch.cumsum(rel, dim=0) / positions
    n_rel = rel.sum()
    return torch.where(n_rel > 0, (prec_at_rel * rel).sum() / n_rel.clamp(min=1), 0.0)


def retrieval_reciprocal_rank(preds: Tensor, target: Tensor) -> Tensor:
    """Reciprocal rank of the first relevant document.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_reciprocal_rank
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([False, True, False])
        >>> float(retrieval_reciprocal_rank(preds, target))
        0.5
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    rel = sorted_by_preds(preds, target) > 0
    position = _first_true(rel)
    return torch.where(rel.any(), 1.0 / (position + 1.0), 0.0)


def _check_k(k: Optional[int], length: int) -> int:
    k = length if k is None else k
    if not (isinstance(k, int) and k > 0):
        raise ValueError("`k` has to be a positive integer or None")
    return k


def retrieval_precision(preds: Tensor, target: Tensor, k: Optional[int] = None, adaptive_k: bool = False) -> Tensor:
    """Precision@k for one query.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([False, True, True])
        >>> float(retrieval_precision(preds, target, k=2))
        1.0
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    if k is None or (adaptive_k and k > preds.shape[-1]):
        k = preds.shape[-1]
    k = _check_k(k, preds.shape[-1])
    relevant = (sorted_by_preds(preds, target)[:k] > 0).sum().to(torch.float32)
    return torch.where(target.sum() > 0, relevant / k, 0.0)


def retrieval_recall(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """Recall@k for one query.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_recall
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([False, True, True])
        >>> float(retrieval_recall(preds, target, k=2))
        1.0
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    k = _check_k(k, preds.shape[-1])
    relevant = (sorted_by_preds(preds, target)[:k] > 0).sum().to(torch.float32)
    n_rel = target.sum()
    return torch.where(n_rel > 0, relevant / n_rel.clamp(min=1), 0.0)


def retrieval_hit_rate(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """HitRate@k for one query.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_hit_rate
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([False, True, True])
        >>> float(retrieval_hit_rate(preds, target, k=2))
        1.0
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    k = _check_k(k, preds.shape[-1])
    relevant = (sorted_by_preds(preds, target)[:k] > 0).sum()
    return (relevant > 0).to(torch.float32)


def retrieval_fall_out(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """FallOut@k for one query: the share of the non-relevant documents
    that are retrieved in the top k.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_fall_out
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([False, True, True])
        >>> float(retrieval_fall_out(preds, target, k=2))
        0.0
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    k = _check_k(k, preds.shape[-1])
    nonrel = (target <= 0).to(torch.int32)  # the JAX package's int32 `1 - (target > 0)`
    retrieved = sorted_by_preds(preds, nonrel)[:k].sum().to(torch.float32)
    n_nonrel = nonrel.sum()
    return torch.where(n_nonrel > 0, retrieved / n_nonrel.clamp(min=1), 0.0)


def _dcg(target: Tensor) -> Tensor:
    """DCG of an ordered float32 relevance list."""
    denom = torch.log2(torch.arange(target.shape[-1], dtype=torch.float32, device=target.device) + 2.0)
    return (target / denom).sum(dim=-1)


def retrieval_normalized_dcg(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """nDCG@k for one query (graded relevance allowed).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_normalized_dcg
        >>> preds = torch.tensor([.1, .2, .3, 4, 70])
        >>> target = torch.tensor([10, 0, 0, 1, 5])
        >>> round(float(retrieval_normalized_dcg(preds, target)), 4)
        0.6957
    """
    preds, target = _check_retrieval_functional_inputs(preds, target, allow_non_binary_target=True)
    k = _check_k(k, preds.shape[-1])
    sorted_target = sorted_by_preds(preds, target)[:k]
    # the ideal order is a plain value sort, not the ranking kernel
    ideal_target = torch.sort(target.to(torch.float32), descending=True).values[:k]
    ideal_dcg = _dcg(ideal_target)
    target_dcg = _dcg(sorted_target.to(torch.float32))
    return torch.where(ideal_dcg > 0, target_dcg / ideal_dcg.clamp(min=1e-12), 0.0)


def retrieval_r_precision(preds: Tensor, target: Tensor) -> Tensor:
    """R-precision for one query: precision at R, the number of relevant
    documents (one host read of ``target.sum()`` for the slice).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_r_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([False, True, True])
        >>> float(retrieval_r_precision(preds, target))
        1.0
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    relevant_number = int(target.sum())
    if not relevant_number:
        return torch.tensor(0.0, device=preds.device)
    relevant = (sorted_by_preds(preds, target)[:relevant_number] > 0).sum().to(torch.float32)
    return relevant / relevant_number
