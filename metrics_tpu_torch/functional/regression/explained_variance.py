"""Explained variance: port of ``metrics_tpu/functional/regression/explained_variance.py``."""
from typing import Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utilities.checks import _check_same_shape


def _explained_variance_update(preds: Tensor, target: Tensor) -> Tuple[int, Tensor, Tensor, Tensor, Tensor]:
    """Running sums of the error's and the target's moments over dim 0."""
    _check_same_shape(preds, target)
    n_obs = preds.shape[0]
    diff = target - preds
    sum_error = torch.sum(diff, dim=0)
    sum_squared_error = torch.sum(diff * diff, dim=0)
    sum_target = torch.sum(target, dim=0)
    sum_squared_target = torch.sum(target * target, dim=0)
    return n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target


def _explained_variance_compute(
    n_obs: Union[int, Tensor],
    sum_error: Tensor,
    sum_squared_error: Tensor,
    sum_target: Tensor,
    sum_squared_target: Tensor,
    multioutput: str = "uniform_average",
) -> Tensor:
    diff_avg = sum_error / n_obs
    numerator = sum_squared_error / n_obs - diff_avg * diff_avg

    target_avg = sum_target / n_obs
    denominator = sum_squared_target / n_obs - target_avg * target_avg

    nonzero_numerator = numerator != 0
    nonzero_denominator = denominator != 0
    valid_score = nonzero_numerator & nonzero_denominator
    output_scores = torch.ones_like(torch.atleast_1d(diff_avg), dtype=torch.float32)
    safe_denominator = torch.where(nonzero_denominator, denominator, 1.0)
    output_scores = torch.where(
        torch.atleast_1d(valid_score), 1.0 - torch.atleast_1d(numerator / safe_denominator), output_scores
    )
    output_scores = torch.where(torch.atleast_1d(nonzero_numerator & ~nonzero_denominator), 0.0, output_scores)
    output_scores = output_scores.reshape(diff_avg.shape)

    if multioutput == "raw_values":
        return output_scores
    if multioutput == "uniform_average":
        return torch.mean(output_scores)
    if multioutput == "variance_weighted":
        denom_sum = torch.sum(denominator)
        return torch.sum(denominator / denom_sum * output_scores)
    raise ValueError(f"Invalid input to multioutput: {multioutput}")


def explained_variance(preds: Tensor, target: Tensor, multioutput: str = "uniform_average") -> Tensor:
    """Explained variance score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import explained_variance
        >>> target = torch.tensor([3.0, -0.5, 2, 7])
        >>> preds = torch.tensor([2.5, 0.0, 2, 8])
        >>> round(float(explained_variance(preds, target)), 4)
        0.9572
    """
    n_obs, sum_error, ss_error, sum_target, ss_target = _explained_variance_update(preds, target)
    return _explained_variance_compute(n_obs, sum_error, ss_error, sum_target, ss_target, multioutput)
