"""Specificity module metric: port of ``metrics_tpu/classification/specificity.py``."""
from torch import Tensor

from metrics_tpu_torch.classification.precision_recall import _AveragedStatScores
from metrics_tpu_torch.functional.classification.specificity import _specificity_compute


class Specificity(_AveragedStatScores):
    """Specificity: tn / (tn + fp).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Specificity
        >>> specificity = Specificity(average='macro', num_classes=3, device="cpu")
        >>> round(float(specificity(torch.tensor([2, 0, 2, 1]), torch.tensor([1, 1, 2, 0]))), 4)
        0.6111
    """

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _specificity_compute(tp, fp, tn, fn, self.average, self.mdmc_reduce)
