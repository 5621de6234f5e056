"""Peak signal-to-noise ratio: port of ``metrics_tpu/functional/image/psnr.py``.

The dtypes follow the JAX package's promotion. A range or base given as a
number is weakly typed there (``jnp.asarray(float)``), so here it is a
Python float holding the float32 value (``log`` and ``10 / log(base)``
computed in float32 on the host) and the error's dtype carries through; a
range held as a tensor (a state, or the targets' extent) promotes with the
error as arrays do in JAX, whatever their ranks.
"""
from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utilities.distributed import reduce
from metrics_tpu_torch.utilities.prints import rank_zero_warn


def _float32(fn, x: float) -> float:
    """``fn`` of ``x`` in float32, as a Python float holding those bits."""
    return float(fn(torch.tensor(float(x), dtype=torch.float32)))


def _psnr_compute(
    sum_squared_error: Tensor,
    n_obs: Union[int, Tensor],
    data_range: Union[float, Tensor],
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """PSNR from an accumulated squared error and its count."""
    log_mse = torch.log(sum_squared_error / n_obs)
    if isinstance(data_range, Tensor):
        log_range = 2 * torch.log(data_range)
        dtype = torch.promote_types(log_range.dtype, log_mse.dtype)
        psnr_base_e = log_range.to(dtype) - log_mse.to(dtype)
    else:
        psnr_base_e = 2 * _float32(torch.log, data_range) - log_mse
    psnr_vals = psnr_base_e * _float32(lambda b: 10 / torch.log(b), base)
    return reduce(psnr_vals, reduction=reduction)


def _psnr_update(
    preds: Tensor,
    target: Tensor,
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tuple[Tensor, Union[int, Tensor]]:
    """The sum of squared errors and its count: a Python int over the whole
    input, else an int64 tensor of the error's shape."""
    if dim is None:
        return torch.sum(torch.square(preds - target)), target.numel()

    diff = preds - target
    dim_list = [dim] if isinstance(dim, int) else list(dim)
    # jnp.sum over no axis reduces nothing; torch.sum over an empty dim list reduces everything
    sum_squared_error = torch.sum(diff * diff, dim=dim_list) if dim_list else diff * diff
    if not dim_list:
        return sum_squared_error, torch.full((), target.numel(), dtype=torch.int64, device=target.device)
    n = 1
    for d in dim_list:
        n *= target.shape[d]
    return sum_squared_error, torch.full(sum_squared_error.shape, n, dtype=torch.int64, device=target.device)


def peak_signal_noise_ratio(
    preds: Tensor,
    target: Tensor,
    data_range: Optional[float] = None,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tensor:
    """PSNR; ``data_range=None`` takes the target's range (on its device).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import peak_signal_noise_ratio
        >>> pred = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> round(float(peak_signal_noise_ratio(pred, target)), 4)
        2.5527
    """
    if dim is None and reduction != "elementwise_mean":
        rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")

    if data_range is None:
        if dim is not None:
            raise ValueError("The `data_range` must be given when `dim` is not None.")
        data_range = target.max() - target.min()
    sum_squared_error, n_obs = _psnr_update(preds, target, dim=dim)
    return _psnr_compute(sum_squared_error, n_obs, data_range, base=base, reduction=reduction)
