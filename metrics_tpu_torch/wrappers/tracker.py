"""MetricTracker: a copy of a metric (or collection) a step, with the best step.

Port of ``metrics_tpu/wrappers/tracker.py``: a plain class, not a ``Metric``.
``increment`` deep-copies the base metric; a copy holds no engine of its
source (``Metric.__getstate__`` and ``MetricCollection.__getstate__`` leave
the CUDA graphs and their buffers out), so each step captures its own.
``best_metric`` reads the stacked values to the host in one transfer.
"""
from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.prints import rank_zero_warn


def _as_value(r: Any) -> Tensor:
    """A step's value as a tensor, as ``jnp.asarray`` takes it: tensors, numbers and sequences of them."""
    if isinstance(r, Tensor):
        return r
    if isinstance(r, (list, tuple)) and all(isinstance(v, Tensor) for v in r):
        return torch.stack(list(r))
    if isinstance(r, (bool, int, float)):
        return torch.tensor(r)
    raise TypeError(f"a step's value must be a tensor or a number to stack, got {type(r).__name__}")


def _to_host(values: Dict[str, Tensor]) -> Dict[str, np.ndarray]:
    """The values as numpy arrays of their shapes, read in one transfer (float64 holds every float32 and int32
    value exactly, so argmax, argmin and the best value are those of the values themselves)."""
    flat = torch.cat([v.reshape(-1).to(torch.float64) for v in values.values()]).cpu().numpy()
    out, at = {}, 0
    for k, v in values.items():
        out[k] = flat[at:at + v.numel()].reshape(tuple(v.shape))
        at += v.numel()
    return out


class MetricTracker:
    """Track a metric (or collection) over steps or epochs: one full copy a
    ``increment()`` call, each accumulating from its increment on.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> from metrics_tpu_torch.wrappers import MetricTracker
        >>> tracker = MetricTracker(Accuracy(num_classes=2, device="cpu"))
        >>> for epoch in range(3):
        ...     tracker.increment()
        ...     tracker.update(torch.tensor([1, 0, 1, int(epoch > 0)]), torch.tensor([1, 0, 1, 1]))
        >>> tracker.best_metric(return_step=True)
        (1.0, 1)
    """

    def __init__(self, metric: Union[Metric, MetricCollection], maximize: Union[bool, List[bool]] = True) -> None:
        if not isinstance(metric, (Metric, MetricCollection)):
            raise TypeError(
                f"Metric arg need to be an instance of a Metric or MetricCollection but got {metric}"
            )
        self._base_metric = metric
        if not isinstance(maximize, (bool, list)):
            raise ValueError("Argument `maximize` should either be a single bool or list of bool")
        if isinstance(maximize, list):
            if not isinstance(metric, MetricCollection) or len(maximize) != len(metric):
                raise ValueError("The len of argument `maximize` should match the length of the metric collection")
        self.maximize = maximize
        self._steps: List[Union[Metric, MetricCollection]] = []
        self._increment_called = False

    def __len__(self) -> int:
        return len(self._steps)

    def __getitem__(self, idx: int) -> Union[Metric, MetricCollection]:
        return self._steps[idx]

    @property
    def n_steps(self) -> int:
        return len(self._steps)

    def increment(self) -> None:
        """Start a new step with a fresh copy of the base metric."""
        self._increment_called = True
        self._steps.append(deepcopy(self._base_metric))

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        self._check_for_increment("forward")
        return self._steps[-1](*args, **kwargs)

    __call__ = forward

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._check_for_increment("update")
        self._steps[-1].update(*args, **kwargs)

    def compute(self) -> Any:
        self._check_for_increment("compute")
        return self._steps[-1].compute()

    def compute_all(self) -> Union[Tensor, Dict[str, Tensor]]:
        """Every step's value, stacked along a new first dim."""
        self._check_for_increment("compute_all")
        res = [m.compute() for m in self._steps]
        if isinstance(self._base_metric, MetricCollection):
            keys = res[0].keys()
            return {k: torch.stack([_as_value(r[k]) for r in res], dim=0) for k in keys}
        return torch.stack([_as_value(r) for r in res], dim=0)

    def reset(self) -> None:
        if self._steps:
            self._steps[-1].reset()

    def reset_all(self) -> None:
        for m in self._steps:
            m.reset()

    def best_metric(
        self, return_step: bool = False
    ) -> Union[
        Optional[float],
        Tuple[Optional[float], Optional[int]],
        Dict[str, Optional[float]],
        Tuple[Dict[str, Optional[float]], Dict[str, Optional[int]]],
    ]:
        """The best value (and its step) by ``maximize``; ``None`` with a
        warning where the values have no single best (e.g. a per-class vector)."""
        if isinstance(self._base_metric, Metric):
            try:
                res = _to_host({"": self.compute_all()})[""]
                idx = int(res.argmax() if self.maximize else res.argmin())
                best = float(res[idx])
                if return_step:
                    return best, idx
                return best
            except (ValueError, TypeError, IndexError) as error:
                rank_zero_warn(
                    f"Encountered the following error when trying to get the best metric: {error}"
                    "this is probably due to the 'best' not being defined for this metric."
                    "Returning `None` instead.",
                    UserWarning,
                )
                if return_step:
                    return None, None
                return None
        res = _to_host(self.compute_all())
        maximize = self.maximize if isinstance(self.maximize, list) else len(res) * [self.maximize]
        value, idx = {}, {}
        for i, (k, v) in enumerate(res.items()):
            try:
                best_i = int(v.argmax() if maximize[i] else v.argmin())
                value[k] = float(v[best_i])
                idx[k] = best_i
            except (ValueError, TypeError, IndexError) as error:
                rank_zero_warn(
                    f"Encountered the following error when trying to get the best metric for metric {k}:"
                    f"{error} this is probably due to the 'best' not being defined for this metric."
                    "Returning `None` instead.",
                    UserWarning,
                )
                value[k], idx[k] = None, None
        if return_step:
            return value, idx
        return value

    def _check_for_increment(self, method: str) -> None:
        if not self._increment_called:
            raise ValueError(f"`{method}` cannot be called before `.increment()` has been called")
