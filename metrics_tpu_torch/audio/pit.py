"""PermutationInvariantTraining module metric: port of ``metrics_tpu/audio/pit.py``."""
import inspect
from typing import Any, Callable

from torch import Tensor

from metrics_tpu_torch.functional.audio.pit import permutation_invariant_training
from metrics_tpu_torch.metric import Metric

# Metric's own constructor arguments; every other keyword goes to metric_func
_BASE_KWARGS = tuple(p for p in inspect.signature(Metric.__init__).parameters if p not in ("self", "kwargs"))


class PermutationInvariantTraining(Metric):
    """Average best-permutation metric over batches. The states are the JAX
    package's: a float32 sum and an int32 count.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PermutationInvariantTraining
        >>> from metrics_tpu_torch.functional import scale_invariant_signal_distortion_ratio
        >>> preds = torch.tensor([[[-0.0579,  0.3560, -0.9604], [-0.1719,  0.3205,  0.2951]]])
        >>> target = torch.tensor([[[ 1.0958, -0.1648,  0.5228], [-0.4100,  1.1942, -0.5103]]])
        >>> pit = PermutationInvariantTraining(scale_invariant_signal_distortion_ratio, 'max', device="cpu")
        >>> round(float(pit(preds, target)), 2)
        -5.11
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, metric_func: Callable, eval_func: str = "max", **kwargs: Any) -> None:
        base_kwargs = {k: kwargs.pop(k) for k in list(kwargs) if k in _BASE_KWARGS}
        super().__init__(**base_kwargs)
        self.metric_func = metric_func
        self.eval_func = eval_func
        self.kwargs = kwargs
        self.add_state("sum_pit_metric", 0.0, dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        pit_metric = permutation_invariant_training(preds, target, self.metric_func, self.eval_func, **self.kwargs)[0]
        self.sum_pit_metric = self.sum_pit_metric + pit_metric.sum().to(self.sum_pit_metric.dtype)
        self.total = self.total + pit_metric.numel()

    def compute(self) -> Tensor:
        return self.sum_pit_metric / self.total
