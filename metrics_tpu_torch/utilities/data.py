"""Tensor helpers and the dim-zero reductions (port of ``metrics_tpu/utilities/data.py``).

The ``dim_zero_*`` functions are the named reductions a metric state can
declare; ``forward`` merges a batch state into the global one with them.
"""
from collections.abc import Mapping, Sequence
from typing import Any, Callable, Dict, List, Optional, Union

import torch
from torch import Tensor


def dim_zero_cat(x: Union[Tensor, List[Tensor]]) -> Tensor:
    """Concatenate a (list of) tensor(s) along dim 0."""
    if isinstance(x, (list, tuple)):
        if not x:
            raise ValueError("No samples to concatenate")
        return torch.cat([torch.atleast_1d(v) for v in x], dim=0)
    return x


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.int32`` as the JAX package names it: ``int32``."""
    return str(dtype).replace("torch.", "")


def dim_zero_sum(x: Tensor) -> Tensor:
    """The sum over dim 0 in ``jnp.sum``'s dtype (32-bit): integers and
    bools count in int32, but an int64 state (a count past 2**31,
    ``Metric._int64_states``) stays int64."""
    wide = x.is_floating_point() or x.is_complex() or x.dtype == torch.int64
    return torch.sum(x, dim=0, dtype=None if wide else torch.int32)


def dim_zero_mean(x: Tensor) -> Tensor:
    """The mean over dim 0; integers and bools give a float32 mean, as ``jnp.mean``."""
    return torch.mean(x if x.is_floating_point() or x.is_complex() else x.to(torch.float32), dim=0)


def dim_zero_max(x: Tensor) -> Tensor:
    return torch.amax(x, dim=0)


def dim_zero_min(x: Tensor) -> Tensor:
    return torch.amin(x, dim=0)


def bucket_pow2(n: int, minimum: int = 8) -> int:
    """Round up to the next power of two (>= ``minimum``).

    The JAX package pads retrieval's per-query rows to this length, and a
    NaN score sorts after the ``-inf`` pads, so the port pads to the same
    length to give the same results. The engines pad a batch to it, so that
    batch sizes within one bucket share one program.
    """
    n = max(n, minimum)
    return 1 << (n - 1).bit_length()


def pad_axis0(x: Tensor, size: int) -> Tensor:
    """Zero-pad ``x`` along dim 0 up to ``size`` rows (a no-op when already
    there; 0-d tensors pass through). Port of ``metrics_tpu/utilities/data.py:55``:
    the companion of :func:`bucket_pow2`, whose padded rows a validity mask
    downstream makes no-ops."""
    if x.ndim == 0 or x.shape[0] >= size:
        return x
    return torch.cat([x, x.new_zeros((size - x.shape[0],) + tuple(x.shape[1:]))])


def _flatten(x: List) -> list:
    """Flatten one level of nesting."""
    return [item for sublist in x for item in sublist]


def _flatten_dict(x: Dict) -> Dict:
    """Flatten a dict of dicts one level."""
    new_dict = {}
    for key, value in x.items():
        if isinstance(value, dict):
            new_dict.update(value)
        else:
            new_dict[key] = value
    return new_dict


def apply_to_collection(
    data: Any,
    dtype: Union[type, tuple],
    function: Callable,
    *args: Any,
    wrong_dtype: Optional[Union[type, tuple]] = None,
    **kwargs: Any,
) -> Any:
    """``function`` applied to every ``dtype`` leaf of nested mappings,
    namedtuples and sequences, the containers rebuilt as they were
    (``metrics_tpu/utilities/data.py:115``)."""
    elem_type = type(data)
    if isinstance(data, dtype) and (wrong_dtype is None or not isinstance(data, wrong_dtype)):
        return function(data, *args, **kwargs)
    if isinstance(data, Mapping):
        return elem_type(
            {k: apply_to_collection(v, dtype, function, *args, wrong_dtype=wrong_dtype, **kwargs) for k, v in data.items()}
        )
    if isinstance(data, tuple) and hasattr(data, "_fields"):  # namedtuple
        return elem_type(*(apply_to_collection(d, dtype, function, *args, wrong_dtype=wrong_dtype, **kwargs) for d in data))
    if isinstance(data, Sequence) and not isinstance(data, str):
        return elem_type([apply_to_collection(d, dtype, function, *args, wrong_dtype=wrong_dtype, **kwargs) for d in data])
    return data


def to_onehot(label_tensor: Tensor, num_classes: int) -> Tensor:
    """``(N, ...)`` integer labels to an int32 one-hot ``(N, C, ...)``.

    Written as a compare against ``arange(C)`` (not ``F.one_hot``) so that a
    label outside ``[0, C)`` gives an all-zero row, as ``jax.nn.one_hot``
    does, instead of raising.
    """
    classes = torch.arange(num_classes, device=label_tensor.device)
    onehot = (label_tensor.long().unsqueeze(-1) == classes).to(torch.int32)
    return torch.movedim(onehot, -1, 1)


def to_categorical(x: Tensor, argmax_dim: int = 1) -> Tensor:
    """Probabilities or logits to the class index along ``argmax_dim`` (the
    first of tied maxima, as ``jnp.argmax``)."""
    return torch.argmax(x, dim=argmax_dim)


def select_topk(prob_tensor: Tensor, topk: int = 1, dim: int = 1) -> Tensor:
    """int32 mask of the ``topk`` highest entries along ``dim``."""
    moved = torch.movedim(prob_tensor, dim, -1)
    if topk == 1:
        idx = torch.argmax(moved, dim=-1, keepdim=True)
    else:
        idx = torch.topk(moved, topk, dim=-1).indices
    mask = torch.zeros(moved.shape, dtype=torch.int32, device=prob_tensor.device)
    mask.scatter_(-1, idx, 1)
    return torch.movedim(mask, -1, dim)


def _squeeze_if_scalar(data: Any) -> Any:
    """Squeeze every single-element tensor to 0-d, also inside lists, tuples
    and dicts (the JAX package maps it over the whole result tree)."""
    if isinstance(data, Tensor):
        return data.squeeze() if data.numel() == 1 else data
    if isinstance(data, (list, tuple)):
        return type(data)(_squeeze_if_scalar(x) for x in data)
    if isinstance(data, dict):
        return {k: _squeeze_if_scalar(v) for k, v in data.items()}
    return data


def _bincount(x: Tensor, minlength: int) -> Tensor:
    """int32 bincount of a flattened tensor with the fixed length
    ``minlength``, as ``jnp.bincount(x, length=minlength)``: a negative value
    counts at 0 and a value past the end adds nothing.

    One ``index_add_`` of fixed shape. ``torch.bincount`` sizes its output by
    the largest value, which reads it back to the host: no CUDA graph could
    hold it (the static audit's JX401).
    """
    idx = x.reshape(-1).long().clamp_min(0)
    inside = idx < minlength
    counts = torch.zeros(minlength, dtype=torch.int32, device=x.device)
    return counts.index_add_(0, torch.where(inside, idx, 0), inside.to(torch.int32))


def get_group_indexes(indexes: Tensor) -> List[Tensor]:
    """Row positions grouped by query id, in order of first appearance: a
    host-side helper of the retrieval API (``metrics_tpu/utilities/data.py:142``;
    the retrieval metrics group on the device instead). One int32 tensor a
    group, on ``indexes``' device."""
    groups: Dict[int, List[int]] = {}
    for i, idx in enumerate(torch.as_tensor(indexes).reshape(-1).tolist()):
        groups.setdefault(idx, []).append(i)
    device = indexes.device if isinstance(indexes, Tensor) else None
    return [torch.tensor(rows, dtype=torch.int32, device=device) for rows in groups.values()]


def allclose(a: Tensor, b: Tensor, rtol: float = 1e-5, atol: float = 1e-8) -> bool:
    """``torch.allclose`` that answers False for different shapes instead of
    broadcasting or raising (``metrics_tpu/utilities/data.py:181``)."""
    if a.shape != b.shape:
        return False
    return bool(torch.allclose(a, b, rtol=rtol, atol=atol))
