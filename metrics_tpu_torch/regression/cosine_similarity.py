"""CosineSimilarity module metric: port of ``metrics_tpu/regression/cosine_similarity.py``.

The rows are kept as list states (``cat``), so a fused collection serves
this member eagerly and ``compute_on_cpu=True`` moves them to the CPU.
"""
from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.functional.regression.cosine_similarity import (
    _cosine_similarity_compute,
    _cosine_similarity_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat


class CosineSimilarity(Metric):
    """Cosine similarity over the accumulated rows.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CosineSimilarity
        >>> target = torch.tensor([[0.0, 1], [1, 1]])
        >>> preds = torch.tensor([[0.0, 1], [0, 1]])
        >>> cosine_similarity = CosineSimilarity(reduction='mean', device="cpu")
        >>> round(float(cosine_similarity(preds, target)), 4)
        0.8536
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, reduction: Optional[str] = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        allowed_reduction = ("sum", "mean", "none", None)
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction

        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _cosine_similarity_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _cosine_similarity_compute(preds, target, self.reduction)
