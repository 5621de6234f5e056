"""ClasswiseWrapper: a per-class result as a dict labelled by class.

Port of ``metrics_tpu/wrappers/classwise.py``. The wrapper takes no device
argument, as in the JAX package: it lives on its metric's device. On the
card each value of the dict is a 0-d view of the result, with no host read.
"""
from typing import Any, Dict, List, Optional

from torch import Tensor

from metrics_tpu_torch.metric import Metric


class ClasswiseWrapper(Metric):
    """Turn a per-class result tensor into ``{metric_label: value}``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> from metrics_tpu_torch.wrappers import ClasswiseWrapper
        >>> metric = ClasswiseWrapper(Accuracy(num_classes=3, average=None, device="cpu"),
        ...                           labels=["horse", "fish", "dog"])
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.2, 0.7, 0.1]])
        >>> target = torch.tensor([0, 1])
        >>> sorted(metric(preds, target).keys())
        ['accuracy_dog', 'accuracy_fish', 'accuracy_horse']
    """

    full_state_update: Optional[bool] = True

    def __init__(self, metric: Metric, labels: Optional[List[str]] = None) -> None:
        if not isinstance(metric, Metric):
            raise ValueError(f"Expected argument `metric` to be an instance of `Metric` but got {metric}")
        if labels is not None and not (isinstance(labels, list) and all(isinstance(lab, str) for lab in labels)):
            raise ValueError(f"Expected argument `labels` to either be `None` or a list of strings but got {labels}")
        super().__init__(device=metric.device)
        self.metric = metric
        self.labels = labels

    def _convert(self, x: Tensor) -> Dict[str, Any]:
        name = self.metric.__class__.__name__.lower()
        if self.labels is None:
            return {f"{name}_{i}": val for i, val in enumerate(x)}
        return {f"{name}_{lab}": val for lab, val in zip(self.labels, x)}

    def update(self, *args: Any, **kwargs: Any) -> None:
        self.metric.update(*args, **kwargs)

    def compute(self) -> Dict[str, Tensor]:
        return self._convert(self.metric.compute())

    def reset(self) -> None:
        self.metric.reset()
        super().reset()
