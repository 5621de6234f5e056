"""KLDivergence module metric: port of ``metrics_tpu/classification/kl_divergence.py``.

With ``reduction="none"`` (or None) the observations' divergences are kept
as a list state (``cat`` reduce); otherwise their sum.
"""
from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.functional.classification.kl_divergence import _kld_compute, _kld_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat


class KLDivergence(Metric):
    """KL divergence ``D_KL(P || Q)``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import KLDivergence
        >>> p = torch.tensor([[0.36, 0.48, 0.16]])
        >>> q = torch.tensor([[1/3, 1/3, 1/3]])
        >>> kl_divergence = KLDivergence(device="cpu")
        >>> round(float(kl_divergence(p, q)), 4)
        0.0853
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, log_prob: bool = False, reduction: Optional[str] = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(log_prob, bool):
            raise TypeError(f"Expected argument `log_prob` to be bool but got {log_prob}")
        self.log_prob = log_prob
        allowed_reduction = ["mean", "sum", "none", None]
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction

        if self.reduction in ["mean", "sum"]:
            self.add_state("measures", 0.0, dist_reduce_fx="sum")
        else:
            self.add_state("measures", [], dist_reduce_fx="cat")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, p: Tensor, q: Tensor) -> None:
        measures, total = _kld_update(p, q, self.log_prob)
        if self.reduction is None or self.reduction == "none":
            self.measures.append(measures)
        else:
            self.measures = self.measures + measures.sum()
        self.total = self.total + total

    def compute(self) -> Tensor:
        measures = dim_zero_cat(self.measures) if self.reduction in ["none", None] else self.measures
        return _kld_compute(measures, self.total, self.reduction)
