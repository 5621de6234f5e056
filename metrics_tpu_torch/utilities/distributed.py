"""Reduction helpers shared across metrics: port of ``metrics_tpu/utilities/distributed.py``,
and ``gather_all_tensors`` (``metrics_tpu/parallel/dist_env.py:226``), the
cross-process gather of :mod:`metrics_tpu_torch.parallel`.
"""
from typing import Any, List, Optional

import torch
from torch import Tensor


def reduce(x: Tensor, reduction: Optional[str]) -> Tensor:
    """Reduce a tensor by ``"elementwise_mean"``, ``"sum"`` or ``"none"``/``None``."""
    if reduction == "elementwise_mean":
        # as jnp.mean: an integer input gives a float32 mean
        return torch.mean(x if x.is_floating_point() else x.to(torch.float32))
    if reduction == "sum":
        # as jnp.sum: an int32 sum stays int32 and a bool sum is int32
        return torch.sum(x, dtype=torch.int32 if x.dtype in (torch.bool, torch.int32) else None)
    if reduction is None or reduction == "none":
        return x
    raise ValueError("Reduction parameter unknown.")


def class_reduce(num: Tensor, denom: Tensor, weights: Tensor, class_reduction: str = "none") -> Tensor:
    """Per-class fractions ``num / denom`` reduced by ``"micro"``, ``"macro"``,
    ``"weighted"`` (by ``weights``, usually the support) or ``"none"``/``None``;
    0/0 counts as 0."""
    valid_reduction = ("micro", "macro", "weighted", "none", None)
    fraction = torch.sum(num) / torch.sum(denom) if class_reduction == "micro" else num / denom
    fraction = torch.where(torch.isnan(fraction), torch.zeros_like(fraction), fraction)

    if class_reduction == "micro":
        return fraction
    if class_reduction == "macro":
        return torch.mean(fraction)
    if class_reduction == "weighted":
        return torch.sum(fraction * (weights / torch.sum(weights)))
    if class_reduction == "none" or class_reduction is None:
        return fraction
    raise ValueError(f"Reduction parameter {class_reduction} unknown. Choose between one of these: {valid_reduction}")


def gather_all_tensors(x: Tensor, env: Optional[Any] = None) -> List[Tensor]:
    """``x`` from every rank of ``env``, a
    :class:`~metrics_tpu_torch.parallel.DistEnv` (the ambient one by
    default), leading dims allowed to differ: one tensor a rank."""
    from metrics_tpu_torch.parallel.dist_env import default_env  # the package imports this module

    return (env or default_env()).all_gather(x)
