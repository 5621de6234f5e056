"""Top-label calibration error (ECE, MCE, RMSCE): port of
``metrics_tpu/functional/classification/calibration_error.py``.

The bins are the JAX package's: ``jnp.linspace(0, 1, n_bins + 1,
dtype=float32)``, whose float32 boundaries differ from ``torch.linspace``'s
for most ``n_bins`` (the default 15 among them), so they are built here as
XLA computes them (:func:`_bin_boundaries`). A confidence is
binned by ``searchsorted`` and the bins' counts and sums are one
scatter-add each, accumulated in float64 and rounded once to float32: the
card's atomics add in any order, and this way the card and the CPU give the
same bins.
"""
from typing import Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.utilities.checks import _input_format_classification
from metrics_tpu_torch.utilities.enums import DataType


def _bin_boundaries(n_bins: int, device: torch.device = torch.device("cpu")) -> Tensor:
    """``jnp.linspace(0, 1, n_bins + 1, dtype=float32)`` bit for bit. JAX
    divides ``iota / n_bins`` in float32, and XLA folds a division by a
    constant into a multiplication by its float32 reciprocal; then ``start *
    (1 - step) + stop * step``, and ``stop`` itself as the last boundary.
    Built in numpy float32 (one IEEE multiplication a step) on the host."""
    start, stop = np.float32(0.0), np.float32(1.0)
    step = np.arange(n_bins, dtype=np.float32) * (np.float32(1.0) / np.float32(n_bins))
    out = np.concatenate([start * (np.float32(1.0) - step) + stop * step, [stop]]).astype(np.float32)
    return torch.from_numpy(out).to(device)


def _binning_bucketize(
    confidences: Tensor, accuracies: Tensor, bin_boundaries: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Each bin's mean accuracy, mean confidence and share of the samples."""
    bin_boundaries = bin_boundaries.to(confidences.device)
    n_bins = bin_boundaries.shape[0] - 1
    indices = torch.clamp(torch.searchsorted(bin_boundaries, confidences, right=False) - 1, 0, n_bins - 1)

    def bin_sums(values: Tensor) -> Tensor:
        sums = torch.zeros(n_bins, dtype=torch.float64, device=confidences.device)
        return sums.index_add_(0, indices, values.to(torch.float64)).to(confidences.dtype)

    count_bin = bin_sums(torch.ones_like(confidences))
    conf_bin = bin_sums(confidences)
    acc_bin = bin_sums(accuracies)

    safe = torch.where(count_bin == 0, 1.0, count_bin)
    conf_bin = torch.where(count_bin == 0, 0.0, conf_bin / safe)
    acc_bin = torch.where(count_bin == 0, 0.0, acc_bin / safe)
    prop_bin = count_bin / count_bin.sum()
    return acc_bin, conf_bin, prop_bin


def _ce_compute(
    confidences: Tensor,
    accuracies: Tensor,
    bin_boundaries: Tensor,
    norm: str = "l1",
    debias: bool = False,
) -> Tensor:
    """The calibration error under ``norm``; ``debias`` corrects the l2 norm."""
    if norm not in {"l1", "l2", "max"}:
        raise ValueError(f"Norm {norm} is not supported. Please select from l1, l2, or max. ")

    acc_bin, conf_bin, prop_bin = _binning_bucketize(confidences, accuracies, bin_boundaries)

    if norm == "l1":
        return torch.sum(torch.abs(acc_bin - conf_bin) * prop_bin)
    if norm == "max":
        return torch.max(torch.abs(acc_bin - conf_bin))
    # l2
    ce = torch.sum((acc_bin - conf_bin) ** 2 * prop_bin)
    if debias:
        debias_bins = (acc_bin * (acc_bin - 1) * prop_bin) / (prop_bin * confidences.shape[0] - 1)
        ce = ce + torch.sum(torch.nan_to_num(debias_bins))
    return torch.where(ce > 0, torch.sqrt(torch.where(ce > 0, ce, 1.0)), 0.0)


def _ce_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """The top-1 confidence of each sample and whether its class is right."""
    _, _, mode = _input_format_classification(preds, target)

    if mode == DataType.BINARY:
        confidences, accuracies = preds, target
    elif mode == DataType.MULTICLASS:
        confidences = preds.amax(dim=1)
        predictions = preds.argmax(dim=1)
        accuracies = predictions == target
    elif mode == DataType.MULTIDIM_MULTICLASS:
        flat = preds.transpose(1, -1).reshape(-1, preds.shape[1])
        confidences = flat.amax(dim=1)
        predictions = flat.argmax(dim=1)
        accuracies = predictions == target.reshape(-1)
    else:
        raise ValueError(
            f"Calibration error is not well-defined for data with size {tuple(preds.shape)} and targets"
            f" {tuple(target.shape)}."
        )
    return confidences.to(torch.float32), accuracies.to(torch.float32)


def calibration_error(preds: Tensor, target: Tensor, n_bins: int = 15, norm: str = "l1") -> Tensor:
    """Top-label calibration error: the l1 norm is the ECE, max the MCE and
    l2 the RMSCE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import calibration_error
        >>> preds = torch.tensor([[0.9, 0.1], [0.6, 0.4], [0.2, 0.8]])
        >>> round(float(calibration_error(preds, torch.tensor([0, 0, 1]), n_bins=3)), 4)
        0.2333
    """
    if norm not in ("l1", "l2", "max"):
        raise ValueError(f"Norm {norm} is not supported. Please select from l1, l2, or max. ")
    if not isinstance(n_bins, int) or n_bins <= 0:
        raise ValueError(f"Expected argument `n_bins` to be a int larger than 0 but got {n_bins}")

    confidences, accuracies = _ce_update(preds, target)
    return _ce_compute(confidences, accuracies, _bin_boundaries(n_bins, confidences.device), norm=norm)
