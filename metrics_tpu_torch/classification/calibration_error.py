"""CalibrationError module metric: port of ``metrics_tpu/classification/calibration_error.py``.

``bin_boundaries`` is a tensor attribute, not a state: it follows the metric
across ``.to()`` (``_device_attributes``), and ``compute`` bins on the
states' device, the CPU after ``compute_on_cpu=True``.
"""
from typing import Any

from torch import Tensor

from metrics_tpu_torch.functional.classification.calibration_error import _bin_boundaries, _ce_compute, _ce_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat


class CalibrationError(Metric):
    """Top-label calibration error: ECE (``"l1"``), MCE (``"max"``) or
    RMSCE (``"l2"``).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CalibrationError
        >>> m = CalibrationError(n_bins=3, device="cpu")
        >>> m.update(torch.tensor([[0.9, 0.1], [0.6, 0.4], [0.2, 0.8]]), torch.tensor([0, 0, 1]))
        >>> round(float(m.compute()), 4)
        0.2333
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    DISTANCES = {"l1", "l2", "max"}
    _device_attributes = ("bin_boundaries",)

    def __init__(self, n_bins: int = 15, norm: str = "l1", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if norm not in self.DISTANCES:
            raise ValueError(f"Norm {norm} is not supported. Please select from l1, l2, or max. ")
        if not isinstance(n_bins, int) or n_bins <= 0:
            raise ValueError(f"Expected argument `n_bins` to be a int larger than 0 but got {n_bins}")
        self.n_bins = n_bins
        self.norm = norm
        self.bin_boundaries = _bin_boundaries(n_bins, self.device)
        self.add_state("confidences", [], dist_reduce_fx="cat")
        self.add_state("accuracies", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        confidences, accuracies = _ce_update(preds, target)
        self.confidences.append(confidences)
        self.accuracies.append(accuracies)

    def compute(self) -> Tensor:
        confidences = dim_zero_cat(self.confidences)
        accuracies = dim_zero_cat(self.accuracies)
        return _ce_compute(confidences, accuracies, self.bin_boundaries, norm=self.norm)
