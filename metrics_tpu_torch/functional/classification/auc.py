"""Area under a curve by the trapezoidal rule: port of ``metrics_tpu/functional/classification/auc.py``."""
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utilities.checks import _is_traced


def _trapezoid(y: Tensor, x: Tensor) -> Tensor:
    """``jnp.trapezoid(y, x)`` over the last dim: integer inputs promote to
    float32, and the integral is ``0.5 * sum(dx * (y[1:] + y[:-1]))``. The
    float32 sum runs in another order than XLA's, so a long curve's area
    matches the JAX package to a tolerance, not bit for bit."""
    dtype = torch.promote_types(x.dtype, y.dtype)
    if not dtype.is_floating_point:
        dtype = torch.float32
    x, y = x.to(dtype), y.to(dtype)
    dx = x[..., 1:] - x[..., :-1]
    return 0.5 * (dx * (y[..., 1:] + y[..., :-1])).sum(-1)


def _auc_update(x: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
    """Squeeze the curve's coordinates and check that they pair up."""
    if x.ndim > 1:
        x = torch.squeeze(x)
    if y.ndim > 1:
        y = torch.squeeze(y)
    if x.ndim > 1 or y.ndim > 1:
        raise ValueError(f"Expected both `x` and `y` tensor to be 1d, but got tensors with dimension {x.ndim} and {y.ndim}")
    if x.numel() != y.numel():
        raise ValueError(
            f"Expected the same number of elements in `x` and `y` tensor but received {x.numel()} and {y.numel()}"
        )
    return x, y


def _auc_compute_without_check(x: Tensor, y: Tensor, direction: float) -> Tensor:
    """The trapezoidal integral of a curve whose ``x`` is taken as monotone."""
    return _trapezoid(y, x) * direction


def _auc_compute(x: Tensor, y: Tensor, reorder: bool = False) -> Tensor:
    """The trapezoidal integral, after checking that ``x`` is monotone (or
    sorting it, stably, with ``reorder``); a decreasing ``x`` gives the area
    with its sign turned."""
    if reorder:
        x_idx = torch.argsort(x, stable=True)
        x, y = x[x_idx], y[x_idx]

    dx = x[1:] - x[:-1]
    if _is_traced():
        direction = 1.0  # no value to check inside a program, as under the JAX package's tracing
    elif bool((dx < 0).any()):
        if bool((dx <= 0).all()):
            direction = -1.0
        else:
            raise ValueError("The `x` tensor is neither increasing or decreasing. Try setting the reorder argument to `True`.")
    else:
        direction = 1.0
    return _auc_compute_without_check(x, y, direction)


def auc(x: Tensor, y: Tensor, reorder: bool = False) -> Tensor:
    """Area under the curve ``y(x)`` by the trapezoidal rule.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import auc
        >>> x = torch.tensor([0, 1, 2, 3])
        >>> y = torch.tensor([0, 1, 2, 2])
        >>> float(auc(x, y))
        4.0
    """
    x, y = _auc_update(x, y)
    return _auc_compute(x, y, reorder=reorder)
