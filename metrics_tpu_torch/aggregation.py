"""Aggregation metrics: running max/min/sum/cat/mean over a stream of values.

Port of ``metrics_tpu/aggregation.py``. NaN handling follows the JAX
package's masked strategy: :meth:`BaseAggregator._cast_and_nan_mask_input`
returns ``(values, valid_mask)`` and every update applies the mask with the
reduction's neutral element, so ``nan_strategy="ignore"``/``"warn"`` drop
NaN contributions without changing shapes. Raising or warning reads
``isnan(x).any()`` back to the host (one sync an update, as in the JAX
package's eager path); only :class:`CatMetric` drops rows.
"""
import warnings
from typing import Any, Callable, List, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.checks import _is_traced
from metrics_tpu_torch.utilities.data import dim_zero_cat


class BaseAggregator(Metric):
    """Base class for aggregation metrics.

    Args:
        fn: named reduction for the ``value`` state.
        default_value: initial state value (or empty list for ``cat``).
        nan_strategy: 'error' | 'warn' | 'ignore' | float-impute.
    """

    is_differentiable = None
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        fn: Union[Callable, str],
        default_value: Union[Tensor, List, float],
        nan_strategy: Union[str, float] = "error",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_nan_strategy = ("error", "warn", "ignore")
        if isinstance(nan_strategy, str):
            if nan_strategy not in allowed_nan_strategy:
                raise ValueError(
                    f"Arg `nan_strategy` should either be a float or one of {allowed_nan_strategy} "
                    f"but got {nan_strategy}."
                )
        elif isinstance(nan_strategy, bool) or not isinstance(nan_strategy, (int, float)):
            raise ValueError(
                f"Arg `nan_strategy` should either be a float or one of {allowed_nan_strategy} "
                f"but got {nan_strategy}."
            )
        else:
            nan_strategy = float(nan_strategy)
        self.nan_strategy = nan_strategy
        self.add_state("value", default=default_value, dist_reduce_fx=fn)

    def _as_float32(self, x: Union[float, Tensor]) -> Tensor:
        if not isinstance(x, Tensor):
            # a fill on the device, not a copy from the host: a CUDA graph can capture it (MeanMetric's weight=1.0)
            return torch.full((), x, dtype=torch.float32, device=self.device)
        return x.to(torch.float32)

    def _cast_and_nan_check_input(self, x: Union[float, Tensor]) -> Tensor:
        """Cast to float32 and apply the NaN strategy, dropping NaN rows (in an
        engine's program NaN rows are kept, as under ``jax.jit``)."""
        x = self._as_float32(x)
        if isinstance(self.nan_strategy, str):
            nans = torch.isnan(x)
            if not _is_traced() and bool(nans.any()):
                if self.nan_strategy == "error":
                    raise RuntimeError("Encounted `nan` values in tensor")
                if self.nan_strategy == "warn":
                    warnings.warn("Encounted `nan` values in tensor. Will be removed.", UserWarning)
                x = x[~nans]
        else:
            x = torch.where(torch.isnan(x), self.nan_strategy, x)
        return x

    def _cast_and_nan_mask_input(self, x: Union[float, Tensor]) -> Tuple[Tensor, Tensor]:
        """``(values, valid_mask)``: ``"error"`` raises on NaN, ``"warn"``
        warns, both ``"warn"`` and ``"ignore"`` mask NaN lanes out, and an
        impute value replaces NaN and keeps every lane. In an engine's program
        (``metrics_tpu/aggregation.py:85-110`` under a tracer) nothing is read
        back: no raise and no warning, and ``"error"`` keeps the NaN so that
        the poisoned result stays visible."""
        x = self._as_float32(x)
        if isinstance(self.nan_strategy, str):
            nans = torch.isnan(x)
            if not _is_traced() and bool(nans.any()):
                if self.nan_strategy == "error":
                    raise RuntimeError("Encounted `nan` values in tensor")
                if self.nan_strategy == "warn":
                    warnings.warn("Encounted `nan` values in tensor. Will be removed.", UserWarning)
            if self.nan_strategy == "error":
                return x, torch.ones_like(x, dtype=torch.bool)
            return x, ~nans
        return torch.where(torch.isnan(x), self.nan_strategy, x), torch.ones_like(x, dtype=torch.bool)

    def update(self, value: Union[float, Tensor]) -> None:
        """Overwrite in child class."""

    def compute(self) -> Tensor:
        return self.value


class MaxMetric(BaseAggregator):
    """Running maximum of all seen values.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MaxMetric
        >>> m = MaxMetric(device="cpu")
        >>> m.update(torch.tensor([1.0, 3.0, 2.0]))
        >>> float(m.compute())
        3.0
    """

    full_state_update = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("max", -float("inf"), nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value, mask = self._cast_and_nan_mask_input(value)
        if not value.numel():
            return
        masked = torch.where(mask, value, -float("inf"))
        self.value = torch.where(mask.any(), torch.maximum(self.value, masked.max()), self.value)


class MinMetric(BaseAggregator):
    """Running minimum of all seen values.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MinMetric
        >>> m = MinMetric(device="cpu")
        >>> m.update(torch.tensor([1.0, 3.0, 2.0]))
        >>> float(m.compute())
        1.0
    """

    full_state_update = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("min", float("inf"), nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value, mask = self._cast_and_nan_mask_input(value)
        if not value.numel():
            return
        masked = torch.where(mask, value, float("inf"))
        self.value = torch.where(mask.any(), torch.minimum(self.value, masked.min()), self.value)


class SumMetric(BaseAggregator):
    """Running sum of all seen values.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SumMetric
        >>> m = SumMetric(device="cpu")
        >>> m.update(torch.tensor([1.0, 3.0, 2.0]))
        >>> float(m.compute())
        6.0
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", 0.0, nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value, mask = self._cast_and_nan_mask_input(value)
        self.value = self.value + torch.where(mask, value, 0.0).sum()


class CatMetric(BaseAggregator):
    """Concatenate all seen values (an unbounded list state; the sketches
    of :mod:`metrics_tpu_torch.streaming` are the bounded alternatives).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CatMetric
        >>> m = CatMetric(device="cpu")
        >>> m.update(torch.tensor([1.0, 2.0]))
        >>> m.update(torch.tensor(3.0))
        >>> [float(v) for v in m.compute()]
        [1.0, 2.0, 3.0]
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("cat", [], nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value = self._cast_and_nan_check_input(value)
        if value.numel():
            self.value.append(value)

    def compute(self) -> Tensor:
        if isinstance(self.value, list) and self.value:
            return dim_zero_cat(self.value)
        return self.value


class MeanMetric(BaseAggregator):
    """Weighted running mean.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanMetric
        >>> m = MeanMetric(device="cpu")
        >>> m.update(torch.tensor([1.0, 3.0, 2.0]))
        >>> float(m.compute())
        2.0
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", 0.0, nan_strategy, **kwargs)
        self.add_state("weight", default=0.0, dist_reduce_fx="sum")

    def update(self, value: Union[float, Tensor], weight: Union[float, Tensor] = 1.0) -> None:
        value, v_mask = self._cast_and_nan_mask_input(value)
        weight, w_mask = self._cast_and_nan_mask_input(weight)
        if value.numel() == 0:
            return
        # one joint mask: a NaN in either lane drops the pair
        weight = torch.broadcast_to(weight, value.shape)
        mask = v_mask & torch.broadcast_to(w_mask, value.shape)
        self.value = self.value + torch.where(mask, value * weight, 0.0).sum()
        self.weight = self.weight + torch.where(mask, weight, 0.0).sum()

    def compute(self) -> Tensor:
        return self.value / self.weight
