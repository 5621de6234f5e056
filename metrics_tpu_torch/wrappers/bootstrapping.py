"""BootStrapper: bootstrap confidence intervals for any metric.

Port of ``metrics_tpu/wrappers/bootstrapping.py``. The resample indices are
drawn on the host from a numpy ``RandomState`` (``_rng``), as in the JAX
package, so that two runs of either package seeded alike draw the same
indices; each copy's indices then cross to the metric's device once a batch
and select the rows with ``index_select``.
"""
from copy import deepcopy
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import apply_to_collection


def _bootstrap_sampler(
    size: int, sampling_strategy: str = "poisson", rng: Optional[np.random.RandomState] = None
) -> Tensor:
    """Resample-with-replacement indices along dim 0, as an int64 CPU tensor."""
    rng = rng or np.random
    if sampling_strategy == "poisson":
        n = rng.poisson(1, size)
        return torch.from_numpy(np.repeat(np.arange(size), n))
    if sampling_strategy == "multinomial":
        return torch.from_numpy(np.asarray(rng.randint(0, size, size), dtype=np.int64))
    raise ValueError("Unknown sampling strategy")


class BootStrapper(Metric):
    """Keep ``num_bootstraps`` copies of a metric, each fed a resample of
    every batch; ``compute`` gives their mean, standard deviation
    (``correction=1``), quantiles (linear interpolation, over all copies'
    values flattened, as ``jnp.quantile`` with no axis) and raw values.

    The wrapper lives on the base metric's device unless ``device`` is given.
    Seed ``_rng`` (a ``numpy.random.RandomState``) for reproducible draws.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import BootStrapper, MeanMetric
        >>> b = BootStrapper(MeanMetric(device="cpu"), num_bootstraps=10)
        >>> b.update(torch.tensor([1.0, 2.0, 3.0, 4.0]))
        >>> sorted(b.compute().keys())
        ['mean', 'std']
    """

    full_state_update: Optional[bool] = True

    def __init__(
        self,
        base_metric: Metric,
        num_bootstraps: int = 10,
        mean: bool = True,
        std: bool = True,
        quantile: Optional[Union[float, Tensor]] = None,
        raw: bool = False,
        sampling_strategy: str = "poisson",
        **kwargs: Any,
    ) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(f"Expected base metric to be an instance of Metric but received {base_metric}")
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)

        self.metrics = [deepcopy(base_metric) for _ in range(num_bootstraps)]
        self.num_bootstraps = num_bootstraps

        self.mean = mean
        self.std = std
        self.quantile = quantile
        self.raw = raw

        allowed_sampling = ("poisson", "multinomial")
        if sampling_strategy not in allowed_sampling:
            raise ValueError(
                f"Expected argument ``sampling_strategy`` to be one of {allowed_sampling}"
                f" but received {sampling_strategy}"
            )
        self.sampling_strategy = sampling_strategy
        self._rng = np.random.RandomState()

    def _on_device(self, idx: Tensor) -> Tensor:
        """Host indices on the metric's device: on the card from pinned memory, without waiting."""
        if self.device.type == "cuda":
            return idx.pin_memory().to(self.device, non_blocking=True)
        return idx.to(self.device)

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update each copy on a fresh resample of the batch."""
        for idx in range(self.num_bootstraps):
            sizes = [len(a) for a in args if isinstance(a, Tensor)]
            sizes += [len(v) for v in kwargs.values() if isinstance(v, Tensor)]
            if not sizes:
                raise ValueError("None of the input contained tensors, so could not determine the sampling size")
            sample_idx = self._on_device(_bootstrap_sampler(sizes[0], self.sampling_strategy, self._rng))
            new_args = apply_to_collection(args, Tensor, lambda x: x.index_select(0, sample_idx))
            new_kwargs = apply_to_collection(kwargs, Tensor, lambda x: x.index_select(0, sample_idx))
            self.metrics[idx].update(*new_args, **new_kwargs)

    def compute(self) -> Dict[str, Tensor]:
        """``mean``, ``std``, ``quantile`` and ``raw`` over the copies' values."""
        computed_vals = torch.stack([m.compute() for m in self.metrics], dim=0)
        output_dict = {}
        if self.mean:
            output_dict["mean"] = computed_vals.mean(dim=0)
        if self.std:
            output_dict["std"] = computed_vals.std(dim=0, correction=1)
        if self.quantile is not None:
            vals = computed_vals if computed_vals.is_floating_point() else computed_vals.to(torch.float32)
            q = torch.as_tensor(self.quantile, dtype=vals.dtype, device=vals.device)
            output_dict["quantile"] = torch.quantile(vals, q, interpolation="linear")
        if self.raw:
            output_dict["raw"] = computed_vals
        return output_dict

    def reset(self) -> None:
        for m in self.metrics:
            m.reset()
        super().reset()
