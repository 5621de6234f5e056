"""``RetrievalMetric``: accumulate ``(indexes, preds, target)`` rows and
average a per-query score over every query at once.

Port of ``metrics_tpu/retrieval/base.py``. ``compute`` scatters the
accumulated rows into a padded ``(Q, L)`` matrix grouped by query id
(:func:`_pad_by_query`, in torch on the metric's device) and scores every
query in one batched pass whose ranking step, each query's labels by
descending score with the ``-inf`` padding last, is one launch of the
``retrieval_sort`` kernel on the card (``sorted_by_preds``). There is no
compiled-program cache to keep: the port runs eagerly.
"""
from abc import ABC, abstractmethod
from typing import Any, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.checks import _check_retrieval_inputs
from metrics_tpu_torch.utilities.data import bucket_pow2, dim_zero_cat
from metrics_tpu_torch.utilities.prints import rank_zero_warn


def _pad_by_query(indexes: Tensor, preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Scatter flat rows into ``(Q, L)`` matrices grouped by query id, each
    query's rows in their order of arrival.

    Returns (padded_preds [-inf pad], padded_target [0 pad], valid mask).
    ``Q`` is the exact number of queries. ``L`` is the JAX package's
    ``bucket_pow2`` of the longest query: a NaN score sorts after the
    ``-inf`` pads, so its rank, and the metric, depend on ``L``. On a card
    this reads two numbers back to the host (the query count inside
    ``torch.unique`` and the longest query).
    """
    _, inverse, counts = torch.unique(indexes, return_inverse=True, return_counts=True)
    num_queries, max_len = counts.numel(), bucket_pow2(int(counts.max()))
    order = torch.argsort(inverse, stable=True)
    offsets = torch.cumsum(counts, dim=0) - counts
    pos_in_group = torch.empty_like(inverse)
    pos_in_group[order] = torch.arange(inverse.numel(), device=inverse.device) - offsets[inverse[order]]

    padded_preds = torch.full((num_queries, max_len), -float("inf"), dtype=torch.float32, device=preds.device)
    padded_target = torch.zeros((num_queries, max_len), dtype=target.dtype, device=target.device)
    padded_preds[inverse, pos_in_group] = preds.to(torch.float32)
    padded_target[inverse, pos_in_group] = target
    # each query fills its first `count` slots
    valid = torch.arange(max_len, device=counts.device)[None, :] < counts[:, None]
    return padded_preds, padded_target, valid


class RetrievalMetric(Metric, ABC):
    """Accumulate (indexes, preds, target) rows; average a per-query metric.

    Args:
        empty_target_action: 'neg' (0.0) | 'pos' (1.0) | 'skip' | 'error'
            for queries with no positive target.
        ignore_index: drop rows whose target equals this value.
    """

    indexes: list
    preds: list
    target: list
    higher_is_better = True
    is_differentiable = False
    full_state_update = False

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.allow_non_binary_target = False

        empty_target_action_options = ("error", "skip", "neg", "pos")
        if empty_target_action not in empty_target_action_options:
            raise ValueError(f"Argument `empty_target_action` received a wrong value `{empty_target_action}`.")
        self.empty_target_action = empty_target_action

        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError("Argument `ignore_index` must be an integer or None.")
        self.ignore_index = ignore_index

        self.add_state("indexes", default=[], dist_reduce_fx=None)
        self.add_state("preds", default=[], dist_reduce_fx=None)
        self.add_state("target", default=[], dist_reduce_fx=None)
        # ragged sync (Metric._gather_ragged): a rank that holds no row still joins every collective through
        # the declared placeholder, and the three states share one lengths gather ("rows"). Indexes cross as
        # int32, preds and targets as float32 (binary and graded targets are exact in float32); unsync
        # restores the local states
        self._ragged_state_specs = {
            "indexes": ((), torch.int32, "rows"),
            "preds": ((), torch.float32, "rows"),
            "target": ((), torch.float32, "rows"),
        }

    def update(self, preds: Tensor, target: Tensor, indexes: Tensor) -> None:
        """Validate, flatten and append."""
        if indexes is None:
            raise ValueError("Argument `indexes` cannot be None")
        indexes, preds, target = _check_retrieval_inputs(
            indexes, preds, target, allow_non_binary_target=self.allow_non_binary_target, ignore_index=self.ignore_index
        )
        self.indexes.append(indexes)
        self.preds.append(preds)
        self.target.append(target)

    def _empty_query_mask(self, padded_target: Tensor, valid: Tensor) -> Tensor:
        """Queries considered 'empty': no positive target by default."""
        return ((padded_target > 0) & valid).sum(dim=1) == 0

    def __setattr__(self, name: str, value: Any) -> None:
        super().__setattr__(name, value)
        # a public attribute (k, empty_target_action, a subclass's own) may
        # change what compute returns: drop the memoised result; the list
        # states mutate by append and never pass through here
        if not name.startswith("_") and name not in ("indexes", "preds", "target"):
            self.__dict__["_computed"] = None

    def _fold(self, scores: Tensor, padded_target: Tensor, valid: Tensor) -> Tuple[Tensor, Tensor]:
        """The mean over queries after the empty-target action, and whether
        any query was empty."""
        real = valid.any(dim=1)
        empty = self._empty_query_mask(padded_target, valid) & real
        action = self.empty_target_action
        if action == "pos":
            scores = torch.where(empty, 1.0, scores)
        elif action == "neg":
            scores = torch.where(empty, 0.0, scores)
        elif action == "skip":
            real = ~empty & real
        n_real = real.sum()
        result = torch.where(n_real > 0, torch.where(real, scores, 0.0).sum() / n_real.clamp(min=1), 0.0)
        return result, empty.any()

    def compute(self) -> Tensor:
        """Every query scored at once, then averaged."""
        indexes = dim_zero_cat(self.indexes)
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)

        padded_preds, padded_target, valid = _pad_by_query(indexes, preds, target)
        scores = self._metric_batched(padded_preds, padded_target, valid)
        result, any_empty = self._fold(scores, padded_target, valid)
        if self.empty_target_action == "error" and bool(any_empty):
            raise ValueError("`compute` method was provided with a query with no positive target.")
        return result

    @abstractmethod
    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        """Single-query metric."""

    def _metric_batched(self, padded_preds: Tensor, padded_target: Tensor, valid: Tensor) -> Tensor:
        """Per-query scores for all queries at once; override for each metric.

        The default loops :meth:`_metric` over the rows on the host; every
        shipped subclass overrides it with a batched implementation.
        """
        cls = type(self)
        # own-dict check: a parent's flag must not silence a subclass
        if "_warned_host_loop_fallback" not in cls.__dict__:
            cls._warned_host_loop_fallback = True
            rank_zero_warn(
                f"{cls.__name__} uses the default per-query host loop for `compute` "
                "(only `_metric` is implemented). Override `_metric_batched` with a "
                "vectorized (Q, L) implementation; every shipped retrieval metric does."
            )
        scores = []
        for q in range(padded_preds.shape[0]):
            m = valid[q]
            scores.append(
                self._metric(padded_preds[q][m], padded_target[q][m])
                if bool(m.any())
                else torch.tensor(0.0, device=padded_preds.device)
            )
        return torch.stack(scores)
