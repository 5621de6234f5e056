"""MinMaxMetric: the running min and max of a wrapped metric's value.

Port of ``metrics_tpu/wrappers/minmax.py``. ``min_val`` and ``max_val`` are
tensor attributes, not states (``metrics_tpu/wrappers/minmax.py:36-37``):
they are not synced or checkpointed, ``reset`` restores them, and ``to``
moves them with the metric (``_device_attributes``).
"""
from typing import Any, Dict, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.metric import Metric


class MinMaxMetric(Metric):
    """Track the min and max of the base metric's computed value.

    The wrapper lives on the base metric's device unless ``device`` is given.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanMetric, MinMaxMetric
        >>> m = MinMaxMetric(MeanMetric(device="cpu"))
        >>> m.update(torch.tensor(2.0))
        >>> _ = m.compute()
        >>> m.update(torch.tensor(4.0))
        >>> sorted((k, round(float(v), 1)) for k, v in m.compute().items())
        [('max', 3.0), ('min', 2.0), ('raw', 3.0)]
    """

    full_state_update: Optional[bool] = True
    _device_attributes = ("min_val", "max_val")

    def __init__(self, base_metric: Metric, **kwargs: Any) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(f"Expected base metric to be an instance of `Metric` but received {base_metric}")
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self._base_metric = base_metric
        self.min_val = torch.tensor(float("inf"), device=self.device)
        self.max_val = torch.tensor(float("-inf"), device=self.device)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._base_metric.update(*args, **kwargs)

    def compute(self) -> Dict[str, Tensor]:
        val = self._base_metric.compute()
        if not self._is_suitable_val(val):
            raise RuntimeError(
                f"Returned value from base metric should be a scalar (int, float or tensor of size 1, but got {val}"
            )
        val = torch.as_tensor(val, device=self.device)
        self.max_val = torch.where(self.max_val < val, val, self.max_val)
        self.min_val = torch.where(self.min_val > val, val, self.min_val)
        return {"raw": val, "max": self.max_val, "min": self.min_val}

    def reset(self) -> None:
        super().reset()
        self._base_metric.reset()
        self.min_val = torch.tensor(float("inf"), device=self.device)
        self.max_val = torch.tensor(float("-inf"), device=self.device)

    @staticmethod
    def _is_suitable_val(val: Union[int, float, Tensor]) -> bool:
        if isinstance(val, (int, float)):
            return True
        if isinstance(val, Tensor):
            return val.numel() == 1
        return False
