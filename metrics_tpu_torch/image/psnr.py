"""PeakSignalNoiseRatio module metric: port of ``metrics_tpu/image/psnr.py``.

The count ``total`` is an int64 state, in both layouts. The JAX package keeps
it in int32 (x64 off), which wraps past 2**31 - 1 values and makes the value
NaN: Cityscapes val at full resolution is 3,145,728,000 values (a reference
fault not copied; ROADMAP.md Queue C). :mod:`metrics_tpu_torch.interop`
widens an int32 count on loading a JAX payload and refuses to export one that
int32 cannot hold.
"""
from typing import Any, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.image.psnr import _psnr_compute, _psnr_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.prints import rank_zero_warn


class PeakSignalNoiseRatio(Metric):
    """PSNR over the accumulated squared error: sums where ``dim`` is None,
    else one value a slice kept as list states (``cat``). With
    ``data_range=None`` the range is the targets' running min and max, on the
    device.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PeakSignalNoiseRatio
        >>> psnr = PeakSignalNoiseRatio(device="cpu")
        >>> preds = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> round(float(psnr(preds, target)), 4)
        2.5527
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    _int64_states = ("total",)

    def __init__(
        self,
        data_range: Optional[float] = None,
        base: float = 10.0,
        reduction: Optional[str] = "elementwise_mean",
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)

        if dim is None and reduction != "elementwise_mean":
            rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")

        if dim is None:
            self.add_state("sum_squared_error", 0.0, dist_reduce_fx="sum")
            self.add_state("total", torch.tensor(0, dtype=torch.int64), dist_reduce_fx="sum")
        else:
            self.add_state("sum_squared_error", [], dist_reduce_fx="cat")
            self.add_state("total", [], dist_reduce_fx="cat")

        if data_range is None:
            if dim is not None:
                raise ValueError("The `data_range` must be given when `dim` is not None.")
            self.data_range = None
            self.add_state("min_target", 0.0, dist_reduce_fx="min")
            self.add_state("max_target", 0.0, dist_reduce_fx="max")
        else:
            self.add_state("data_range", float(data_range), dist_reduce_fx="mean")
        self.base = base
        self.reduction = reduction
        self.dim = tuple(dim) if isinstance(dim, Sequence) else dim

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_error, n_obs = _psnr_update(preds, target, dim=self.dim)
        if self.dim is None:
            if self.data_range is None:
                self.min_target = torch.minimum(target.min(), self.min_target)
                self.max_target = torch.maximum(target.max(), self.max_target)
            self.sum_squared_error = self.sum_squared_error + sum_squared_error
            self.total = self.total + n_obs
        else:
            self.sum_squared_error.append(sum_squared_error)
            self.total.append(n_obs)

    def compute(self) -> Tensor:
        data_range = self.data_range if self.data_range is not None else (self.max_target - self.min_target)
        if self.dim is None:
            sum_squared_error = self.sum_squared_error
            total = self.total
        else:
            sum_squared_error = torch.cat([v.reshape(-1) for v in self.sum_squared_error])
            total = torch.cat([v.expand(s.shape).reshape(-1) for v, s in zip(self.total, self.sum_squared_error)])
        return _psnr_compute(sum_squared_error, total, data_range, base=self.base, reduction=self.reduction)
