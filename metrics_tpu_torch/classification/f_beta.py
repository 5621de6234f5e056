"""F-beta and F1 module metrics: port of ``metrics_tpu/classification/f_beta.py``."""
from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.precision_recall import _AveragedStatScores
from metrics_tpu_torch.functional.classification.f_beta import _fbeta_compute


class FBetaScore(_AveragedStatScores):
    """Weighted harmonic mean of precision and recall.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import FBetaScore
        >>> f_beta = FBetaScore(num_classes=3, beta=0.5, device="cpu")
        >>> round(float(f_beta(torch.tensor([0, 2, 1, 0, 0, 1]), torch.tensor([0, 1, 2, 0, 1, 2]))), 4)
        0.3333
    """

    def __init__(
        self,
        num_classes: Optional[int] = None,
        beta: float = 1.0,
        threshold: float = 0.5,
        average: Optional[str] = "micro",
        mdmc_average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        self.beta = beta
        super().__init__(
            num_classes=num_classes,
            threshold=threshold,
            average=average,
            mdmc_average=mdmc_average,
            ignore_index=ignore_index,
            top_k=top_k,
            multiclass=multiclass,
            **kwargs,
        )

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _fbeta_compute(tp, fp, tn, fn, self.beta, self.ignore_index, self.average, self.mdmc_reduce)


class F1Score(FBetaScore):
    """F1: F-beta with beta = 1.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import F1Score
        >>> f1 = F1Score(num_classes=3, device="cpu")
        >>> round(float(f1(torch.tensor([0, 2, 1, 0, 0, 1]), torch.tensor([0, 1, 2, 0, 1, 2]))), 4)
        0.3333
    """

    def __init__(
        self,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: Optional[str] = "micro",
        mdmc_average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes,
            beta=1.0,
            threshold=threshold,
            average=average,
            mdmc_average=mdmc_average,
            ignore_index=ignore_index,
            top_k=top_k,
            multiclass=multiclass,
            **kwargs,
        )
