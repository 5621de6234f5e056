"""Multilabel ranking metrics (coverage error, label ranking average
precision, label ranking loss): port of ``metrics_tpu/functional/classification/ranking.py``.

Ranks come from one batched pairwise comparison ``preds[:, None, :] >=
preds[:, :, None]`` (``O(N L^2)``, L labels), and the ranking loss's
inverse ranks from a double stable ``argsort``, as ``jnp.argsort`` is
stable: tied scores keep their label order.
"""
from typing import Optional, Tuple

import torch
from torch import Tensor


def _check_ranking_input(preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None) -> None:
    """``(N, L)`` scores and targets, and ``(N,)`` sample weights."""
    if preds.ndim != 2 or target.ndim != 2:
        raise ValueError(
            "Expected both predictions and target to matrices of shape `[N,C]`"
            f" but got {preds.ndim} and {target.ndim}"
        )
    if preds.shape != target.shape:
        raise ValueError("Expected both predictions and target to have same shape")
    if sample_weight is not None:
        if sample_weight.ndim != 1 or sample_weight.shape[0] != preds.shape[0]:
            raise ValueError(
                "Expected sample weights to be 1 dimensional and have same size"
                f" as the first dimension of preds and target but got {tuple(sample_weight.shape)}"
            )


def _weighted_mean(total: Tensor, n_elements: int, sample_weight: Optional[Tensor] = None) -> Tensor:
    """``total`` over the summed sample weight, or over the element count
    where there is no weight or it sums to 0 (chosen on the device: no host
    read)."""
    if sample_weight is None:
        return total / n_elements
    sample_weight = torch.as_tensor(sample_weight, device=total.device)
    return total / torch.where(sample_weight != 0, sample_weight, torch.as_tensor(n_elements, device=total.device))


def _coverage_error_update(
    preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None
) -> Tuple[Tensor, int, Optional[Tensor]]:
    """The summed coverage (how far down the ranking every relevant label is
    reached), the sample count and the summed weight."""
    _check_ranking_input(preds, target, sample_weight)
    offset = torch.where(target == 0, torch.abs(preds.min()) + 10, 0.0)  # any number > 1 works
    preds_mod = preds + offset
    preds_min = preds_mod.amin(dim=1)
    coverage = (preds >= preds_min[:, None]).sum(dim=1).to(torch.float32)
    if isinstance(sample_weight, Tensor):
        coverage = coverage * sample_weight
        sample_weight = sample_weight.sum()
    return coverage.sum(), coverage.numel(), sample_weight


def _coverage_error_compute(coverage: Tensor, n_elements: int, sample_weight: Optional[Tensor] = None) -> Tensor:
    return _weighted_mean(coverage, n_elements, sample_weight)


def coverage_error(preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None) -> Tensor:
    """Multilabel coverage error.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import coverage_error
        >>> preds = torch.tensor([[0.8, 0.3, 0.6], [0.2, 0.7, 0.4]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0]])
        >>> float(coverage_error(preds, target))
        1.5
    """
    coverage, n_elements, sample_weight = _coverage_error_update(preds, target, sample_weight)
    return _coverage_error_compute(coverage, n_elements, sample_weight)


def _label_ranking_average_precision_update(
    preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None
) -> Tuple[Tensor, int, Optional[Tensor]]:
    """The summed per-sample scores: for each relevant label, its rank
    among the relevant labels over its rank among all (a tie takes the
    highest rank), averaged; a sample with no or every label relevant scores 1."""
    _check_ranking_input(preds, target, sample_weight)
    n_preds, n_labels = preds.shape
    relevant = target == 1
    n_rel = relevant.sum(dim=1)

    # geq[i, j, k] = preds[i, k] >= preds[i, j]
    geq = preds[:, None, :] >= preds[:, :, None]
    rank_all = geq.sum(dim=2).to(torch.float32)
    rank_rel = (geq & relevant[:, None, :] & relevant[:, :, None]).sum(dim=2).to(torch.float32)

    per_label = torch.where(relevant, rank_rel / rank_all, 0.0)
    score_idx = per_label.sum(dim=1) / torch.clamp(n_rel, min=1)
    score_idx = torch.where((n_rel == 0) | (n_rel == n_labels), 1.0, score_idx)

    if sample_weight is not None:
        score = (score_idx * sample_weight).sum()
        sample_weight = sample_weight.sum()
    else:
        score = score_idx.sum()
    return score, n_preds, sample_weight


def _label_ranking_average_precision_compute(
    score: Tensor, n_elements: int, sample_weight: Optional[Tensor] = None
) -> Tensor:
    return _weighted_mean(score, n_elements, sample_weight)


def label_ranking_average_precision(preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None) -> Tensor:
    """Label ranking average precision of multilabel data.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import label_ranking_average_precision
        >>> preds = torch.tensor([[0.8, 0.3, 0.6], [0.2, 0.7, 0.4]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0]])
        >>> float(label_ranking_average_precision(preds, target))
        1.0
    """
    score, n_elements, sample_weight = _label_ranking_average_precision_update(preds, target, sample_weight)
    return _label_ranking_average_precision_compute(score, n_elements, sample_weight)


def _label_ranking_loss_update(
    preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None
) -> Tuple[Tensor, int, Optional[Tensor]]:
    """The summed share of (relevant, irrelevant) label pairs ranked the
    wrong way round; a sample with no or every label relevant adds 0."""
    _check_ranking_input(preds, target, sample_weight)
    n_preds, n_labels = preds.shape
    relevant = target == 1
    n_relevant = relevant.sum(dim=1)

    mask = (n_relevant > 0) & (n_relevant < n_labels)

    inverse = torch.argsort(torch.argsort(preds, dim=1, stable=True), dim=1, stable=True)
    per_label_loss = ((n_labels - inverse) * relevant).to(torch.float32)
    correction = 0.5 * n_relevant * (n_relevant + 1)
    denom = n_relevant * (n_labels - n_relevant)
    safe_denom = torch.where(mask, denom, 1)
    loss = torch.where(mask, (per_label_loss.sum(dim=1) - correction) / safe_denom, 0.0)

    if isinstance(sample_weight, Tensor):
        loss = loss * torch.where(mask, sample_weight, 0.0)
        sample_weight = sample_weight.sum()
    return loss.sum(), n_preds, sample_weight


def _label_ranking_loss_compute(loss: Tensor, n_elements: int, sample_weight: Optional[Tensor] = None) -> Tensor:
    return _weighted_mean(loss, n_elements, sample_weight)


def label_ranking_loss(preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None) -> Tensor:
    """Label ranking loss of multilabel data.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import label_ranking_loss
        >>> preds = torch.tensor([[0.8, 0.3, 0.6], [0.2, 0.7, 0.4]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0]])
        >>> float(label_ranking_loss(preds, target))
        0.0
    """
    loss, n_element, sample_weight = _label_ranking_loss_update(preds, target, sample_weight)
    return _label_ranking_loss_compute(loss, n_element, sample_weight)
