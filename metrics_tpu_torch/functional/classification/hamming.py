"""Hamming distance: port of ``metrics_tpu/functional/classification/hamming.py``.

No kernel: the inputs become binary one-hots and one compare-and-sum counts
the matching positions (int32, as in the JAX package); ``total`` is a
Python int.
"""
from typing import Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utilities.checks import _input_format_classification


def _hamming_distance_update(preds: Tensor, target: Tensor, threshold: float = 0.5) -> Tuple[Tensor, int]:
    """Count matching positions and total positions."""
    preds, target, _ = _input_format_classification(preds, target, threshold=threshold)
    correct = (preds == target).sum(dtype=torch.int32)
    return correct, preds.numel()


def _hamming_distance_compute(correct: Tensor, total: Union[int, Tensor]) -> Tensor:
    """1 - matching fraction."""
    return 1 - correct.float() / total


def hamming_distance(preds: Tensor, target: Tensor, threshold: float = 0.5) -> Tensor:
    """Average Hamming distance (loss).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import hamming_distance
        >>> target = torch.tensor([[0, 1], [1, 1]])
        >>> preds = torch.tensor([[0, 1], [0, 1]])
        >>> float(hamming_distance(preds, target))
        0.25
    """
    correct, total = _hamming_distance_update(preds, target, threshold)
    return _hamming_distance_compute(correct, total)
