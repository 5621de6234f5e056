"""MultioutputWrapper: one copy of a metric per output column.

Port of ``metrics_tpu/wrappers/multioutput.py``. The wrapper takes no device
argument, as in the JAX package: it lives on its metric's device. With
``remove_nans`` the rows holding a NaN in any input are dropped per output:
the mask is built on the metric's device, and the rows kept are found with
one ``nonzero`` an output, one host sync on the card (the kept rows' count
sets the shape).
"""
from copy import deepcopy
from typing import Any, List, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import apply_to_collection


class MultioutputWrapper(Metric):
    """Evaluate a single-output metric on each output column on its own.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import R2Score
        >>> from metrics_tpu_torch.wrappers import MultioutputWrapper
        >>> target = torch.tensor([[0.5, 1], [-1, 1], [7, -6]])
        >>> preds = torch.tensor([[0.0, 2], [-1, 2], [8, -5]])
        >>> r2score = MultioutputWrapper(R2Score(device="cpu"), 2)
        >>> [round(float(v), 4) for v in r2score(preds, target)]
        [0.9654, 0.9082]
    """

    is_differentiable = False
    full_state_update: Optional[bool] = True

    def __init__(
        self,
        base_metric: Metric,
        num_outputs: int,
        output_dim: int = -1,
        remove_nans: bool = True,
        squeeze_outputs: bool = True,
    ) -> None:
        super().__init__(device=base_metric.device)
        self.metrics = [deepcopy(base_metric) for _ in range(num_outputs)]
        self.output_dim = output_dim
        self.remove_nans = remove_nans
        self.squeeze_outputs = squeeze_outputs

    def _get_args_kwargs_by_output(self, *args: Tensor, **kwargs: Tensor) -> List[Tuple]:
        """Each output's column of every input (``metrics_tpu/wrappers/multioutput.py:52-81``)."""
        args_kwargs_by_output = []
        for i in range(len(self.metrics)):
            def _select(x: Tensor, idx: int = i) -> Tensor:
                return x.narrow(self.output_dim, idx, 1)

            selected_args = apply_to_collection(args, Tensor, _select)
            selected_kwargs = apply_to_collection(kwargs, Tensor, _select)

            if self.remove_nans:
                flat = [x for x in (*selected_args, *selected_kwargs.values()) if isinstance(x, Tensor)]
                if flat:
                    nan_rows = None
                    for x in flat:
                        rows = torch.isnan(x.reshape(x.shape[0], -1)).any(dim=1)
                        nan_rows = rows if nan_rows is None else nan_rows | rows
                    keep = torch.nonzero(~nan_rows).squeeze(1)  # this output's one host sync on the card
                    selected_args = apply_to_collection(selected_args, Tensor, lambda x: x.index_select(0, keep))
                    selected_kwargs = apply_to_collection(selected_kwargs, Tensor, lambda x: x.index_select(0, keep))

            if self.squeeze_outputs:
                selected_args = apply_to_collection(selected_args, Tensor, lambda x: x.squeeze(self.output_dim))
                selected_kwargs = apply_to_collection(selected_kwargs, Tensor, lambda x: x.squeeze(self.output_dim))
            args_kwargs_by_output.append((selected_args, selected_kwargs))
        return args_kwargs_by_output

    def update(self, *args: Any, **kwargs: Any) -> None:
        reshaped = self._get_args_kwargs_by_output(*args, **kwargs)
        for metric, (selected_args, selected_kwargs) in zip(self.metrics, reshaped):
            metric.update(*selected_args, **selected_kwargs)

    def compute(self) -> List[Tensor]:
        return [m.compute() for m in self.metrics]

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        reshaped = self._get_args_kwargs_by_output(*args, **kwargs)
        results = [
            metric(*selected_args, **selected_kwargs)
            for metric, (selected_args, selected_kwargs) in zip(self.metrics, reshaped)
        ]
        if any(res is None for res in results):
            return None
        return results

    def reset(self) -> None:
        for metric in self.metrics:
            metric.reset()
        super().reset()
