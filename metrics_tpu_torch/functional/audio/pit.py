"""Permutation-invariant training: port of ``metrics_tpu/functional/audio/pit.py``.

The metric of every (target speaker, estimate speaker) pair comes from one
call of ``metric_func`` over the repeated and tiled speakers. Below four
speakers the best permutation is an exhaustive search on the device over a
table of all ``spk!`` permutations (built once per speaker count and device);
from four speakers scipy's Hungarian solver runs on the host, as in the JAX
package: one read of the ``(batch, spk, spk)`` matrix back to the host per
call. ``best_perm`` is int32, the JAX package's dtype.
"""
import functools
from itertools import permutations
from typing import Any, Callable, Tuple

import numpy as np
import torch
from torch import Tensor


@functools.lru_cache(maxsize=None)
def _permutation_table(spk_num: int, device: torch.device) -> Tensor:
    """``(spk, spk!)`` int64: column ``j`` is the ``j``-th permutation in
    ``itertools.permutations`` order."""
    return torch.tensor(list(permutations(range(spk_num))), dtype=torch.int64, device=device).T.contiguous()


def _find_best_perm_by_linear_sum_assignment(metric_mtx: Tensor, maximize: bool) -> Tuple[Tensor, Tensor]:
    """Hungarian assignment per batch element, on the host."""
    from scipy.optimize import linear_sum_assignment

    mmtx = metric_mtx.detach().cpu().numpy()
    best_perm = torch.from_numpy(np.stack([linear_sum_assignment(pwm, maximize)[1] for pwm in mmtx]))
    if metric_mtx.device.type == "cuda":
        best_perm = best_perm.pin_memory().to(metric_mtx.device, non_blocking=True)
    best_metric = torch.gather(metric_mtx, 2, best_perm[:, :, None]).mean(dim=(-1, -2))
    return best_metric, best_perm.to(torch.int32)


def _find_best_perm_by_exhaustive_method(metric_mtx: Tensor, maximize: bool) -> Tuple[Tensor, Tensor]:
    """Exhaustive search over all ``spk!`` permutations, on the device. Ties
    and NaN go to the first permutation, as ``jnp.argmax`` sends them."""
    batch_size, spk_num = metric_mtx.shape[:2]
    ps = _permutation_table(spk_num, metric_mtx.device)  # (spk, perm)
    metric_of_ps = torch.gather(metric_mtx, 2, ps.expand(batch_size, -1, -1)).mean(dim=1)  # (batch, perm)

    if maximize:
        best_metric, best_indexes = torch.max(metric_of_ps, dim=1)
    else:
        best_metric, best_indexes = torch.min(metric_of_ps, dim=1)
    best_perm = ps.T[best_indexes]
    return best_metric, best_perm.to(torch.int32)


def permutation_invariant_training(
    preds: Tensor,
    target: Tensor,
    metric_func: Callable,
    eval_func: str = "max",
    **kwargs: Any,
) -> Tuple[Tensor, Tensor]:
    """Best-permutation metric for ``(batch, spk, ...)`` estimates and targets:
    ``(best_metric (batch,), best_perm (batch, spk) int32)``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import permutation_invariant_training
        >>> from metrics_tpu_torch.functional import scale_invariant_signal_distortion_ratio
        >>> preds = torch.tensor([[[-0.0579,  0.3560, -0.9604], [-0.1719,  0.3205,  0.2951]]])
        >>> target = torch.tensor([[[ 1.0958, -0.1648,  0.5228], [-0.4100,  1.1942, -0.5103]]])
        >>> best_metric, best_perm = permutation_invariant_training(
        ...     preds, target, scale_invariant_signal_distortion_ratio, 'max')
        >>> tuple(best_perm.shape)
        (1, 2)
    """
    if preds.shape[0:2] != target.shape[0:2]:
        raise RuntimeError(
            "Predictions and targets are expected to have the same shape at the batch and speaker dimensions"
        )
    if eval_func not in ["max", "min"]:
        raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
    if target.ndim < 2:
        raise ValueError(
            f"Inputs must be of shape [batch, spk, ...], got {tuple(target.shape)} and {tuple(preds.shape)} instead"
        )

    spk_num = target.shape[1]
    # the metric of all (target_spk, pred_spk) pairs in one call: t0,t0,..,t1,t1,.. against p0,p1,..,p0,p1,..
    t_rep = target.repeat_interleave(spk_num, dim=1)
    p_rep = preds.repeat((1, spk_num) + (1,) * (preds.ndim - 2))
    metric_mtx = metric_func(p_rep, t_rep, **kwargs).reshape(preds.shape[0], spk_num, spk_num)

    maximize = eval_func == "max"
    if spk_num < 4:
        return _find_best_perm_by_exhaustive_method(metric_mtx, maximize)
    return _find_best_perm_by_linear_sum_assignment(metric_mtx, maximize)


def pit_permutate(preds: Tensor, perm: Tensor) -> Tensor:
    """Reorder the speakers of ``preds`` by ``perm`` (``(batch, spk)``).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pit_permutate
        >>> preds = torch.arange(8.0).reshape(1, 2, 4)
        >>> perm = torch.tensor([[1, 0]])  # swap the two speakers
        >>> pit_permutate(preds, perm)[0, 0, 0].item()
        4.0
    """
    index = perm.long()[(...,) + (None,) * (preds.ndim - 2)].expand(preds.shape)
    return torch.gather(preds, 1, index)
