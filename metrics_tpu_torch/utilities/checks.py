"""Classification input validation and canonicalization.

Port of ``metrics_tpu/utilities/checks.py``: the same decision table, the
same errors for the same inputs. The value checks (labels non-negative,
below ``num_classes``) read ``min()``/``max()`` back to the host; on a CUDA
tensor each read waits for the device. They stay, because they are what
gives the JAX package's errors.

The JAX package skips its value checks while ``jax.jit`` traces an update
(``_is_traced``, ``metrics_tpu/utilities/checks.py:54``). A torch tensor is
never a tracer, so the port's engines (:mod:`metrics_tpu_torch.dispatch`)
say so themselves: they run a program inside :func:`tracing`, and
:func:`_is_traced` reads that flag. Under it the checks the JAX package skips
under tracing are skipped at the same places (its ``checks.py:88, 114, 179,
235, 313, 399, 430``), so a program reads nothing back to the host and can be
captured as a CUDA graph; outside it every check runs.
"""
import threading
from contextlib import contextmanager
from typing import Iterator, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utilities.data import select_topk, to_onehot
from metrics_tpu_torch.utilities.enums import DataType


_TRACING = threading.local()


@contextmanager
def tracing() -> Iterator[None]:
    """Run the block as the engines run a program: value checks skipped."""
    depth = getattr(_TRACING, "depth", 0)
    _TRACING.depth = depth + 1
    try:
        yield
    finally:
        _TRACING.depth = depth


def _is_traced() -> bool:
    """Whether an engine is building or running a program on this thread."""
    return getattr(_TRACING, "depth", 0) > 0


def _is_floating(x: Tensor) -> bool:
    return x.is_floating_point()


def _is_integer(x: Tensor) -> bool:
    """Integer dtype in the JAX sense: bool is not an integer type."""
    return not x.is_floating_point() and not x.is_complex() and x.dtype != torch.bool


def _check_for_empty_tensors(preds: Tensor, target: Tensor) -> bool:
    return preds.numel() == 0 and target.numel() == 0


def _check_same_shape(preds: Tensor, target: Tensor) -> None:
    """Raise if predictions and target differ in shape."""
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, "
            f"but got {tuple(preds.shape)} and {tuple(target.shape)}."
        )


def _basic_input_validation(
    preds: Tensor, target: Tensor, threshold: float, multiclass: Optional[bool], ignore_index: Optional[int]
) -> None:
    """Value-level validation."""
    if _check_for_empty_tensors(preds, target):
        return

    if _is_floating(target):
        raise ValueError("The `target` has to be an integer tensor.")

    if not preds.shape[0] == target.shape[0]:
        raise ValueError("The `preds` and `target` should have the same first dimension.")

    if _is_traced():
        return  # the value checks read the device

    if target.min() < 0 and (ignore_index is None or ignore_index >= 0):
        raise ValueError("The `target` has to be a non-negative tensor.")

    preds_float = _is_floating(preds)
    if not preds_float and preds.min() < 0:
        raise ValueError("If `preds` are integers, they have to be non-negative.")

    if multiclass is False and target.max() > 1:
        raise ValueError("If you set `multiclass=False`, then `target` should not exceed 1.")

    if multiclass is False and not preds_float and preds.max() > 1:
        raise ValueError("If you set `multiclass=False` and `preds` are integers, then `preds` should not exceed 1.")


def _check_shape_and_type_consistency(preds: Tensor, target: Tensor) -> Tuple[DataType, int]:
    """Infer the input case from shape and dtype."""
    preds_float = _is_floating(preds)

    if preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError(
                f"The `preds` and `target` should have the same shape, got {tuple(preds.shape)} and {tuple(target.shape)}."
            )
        if preds_float and target.numel() > 0 and not _is_traced() and target.max() > 1:
            raise ValueError(
                "If `preds` and `target` are of shape (N, ...) and `preds` are floats, `target` should be binary."
            )
        if preds.ndim == 1 and preds_float:
            case = DataType.BINARY
        elif preds.ndim == 1 and not preds_float:
            case = DataType.MULTICLASS
        elif preds.ndim > 1 and preds_float:
            case = DataType.MULTILABEL
        else:
            case = DataType.MULTIDIM_MULTICLASS
        implied_classes = int(preds[0].numel()) if preds.numel() > 0 else 0

    elif preds.ndim == target.ndim + 1:
        if not preds_float:
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should be"
                " (N, C, ...), and the shape of `target` should be (N, ...)."
            )
        implied_classes = preds.shape[1] if preds.numel() > 0 else 0
        case = DataType.MULTICLASS if preds.ndim == 2 else DataType.MULTIDIM_MULTICLASS
    else:
        raise ValueError(
            "Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should be (N, ...)"
            " and `preds` should be (N, C, ...)."
        )

    return case, implied_classes


def _check_num_classes_binary(num_classes: int, multiclass: Optional[bool]) -> None:
    if num_classes > 2:
        raise ValueError("Your data is binary, but `num_classes` is larger than 2.")
    if num_classes == 2 and not multiclass:
        raise ValueError(
            "Your data is binary and `num_classes=2`, but `multiclass` is not True."
            " Set it to True if you want to transform binary data to multi-class format."
        )
    if num_classes == 1 and multiclass:
        raise ValueError(
            "You have binary data and have set `multiclass=True`, but `num_classes` is 1."
            " Either set `multiclass=None` (default) or set `num_classes=2`."
        )


def _check_num_classes_mc(
    preds: Tensor, target: Tensor, num_classes: int, multiclass: Optional[bool], implied_classes: int
) -> None:
    if num_classes == 1 and multiclass is not False:
        raise ValueError(
            "You have set `num_classes=1`, but predictions are integers."
            " If you want to convert (multi-dimensional) multi-class data with 2 classes"
            " to binary/multi-label, set `multiclass=False`."
        )
    if num_classes > 1:
        if multiclass is False and implied_classes != num_classes:
            raise ValueError(
                "You have set `multiclass=False`, but the implied number of classes"
                " (from shape of inputs) does not match `num_classes`."
            )
        if target.numel() > 0 and not _is_traced() and num_classes <= target.max():
            raise ValueError("The highest label in `target` should be smaller than `num_classes`.")
        if preds.shape != target.shape and num_classes != implied_classes:
            raise ValueError("The size of C dimension of `preds` does not match `num_classes`.")


def _check_num_classes_ml(num_classes: int, multiclass: Optional[bool], implied_classes: int) -> None:
    if multiclass and num_classes != 2:
        raise ValueError(
            "You have set `multiclass=True`, but `num_classes` is not equal to 2."
            " If you are trying to transform multi-label data to 2-class multi-dim"
            " multi-class, you should set `num_classes` to either 2 or None."
        )
    if not multiclass and num_classes != implied_classes:
        raise ValueError("The implied number of classes (from shape of inputs) does not match num_classes.")


def _check_top_k(top_k: int, case: DataType, implied_classes: int, multiclass: Optional[bool], preds_float: bool) -> None:
    if case == DataType.BINARY:
        raise ValueError("You can not use `top_k` parameter with binary data.")
    if not isinstance(top_k, int) or top_k <= 0:
        raise ValueError("The `top_k` has to be an integer larger than 0.")
    if not preds_float:
        raise ValueError("You have set `top_k`, but you do not have probability predictions.")
    if multiclass is False:
        raise ValueError("If you set `multiclass=False`, you can not set `top_k`.")
    if case == DataType.MULTILABEL and multiclass:
        raise ValueError(
            "If you want to transform multi-label data to 2-class multi-dim"
            " multi-class data using `multiclass=True`, you can not use `top_k`."
        )
    if top_k >= implied_classes:
        raise ValueError("The `top_k` has to be strictly smaller than the `C` dimension of `preds`.")


def _check_classification_inputs(
    preds: Tensor,
    target: Tensor,
    threshold: float,
    num_classes: Optional[int],
    multiclass: Optional[bool],
    top_k: Optional[int],
    ignore_index: Optional[int] = None,
) -> DataType:
    """Full input validation; returns the detected case."""
    _basic_input_validation(preds, target, threshold, multiclass, ignore_index)
    case, implied_classes = _check_shape_and_type_consistency(preds, target)

    if preds.shape != target.shape:
        if multiclass is False and implied_classes != 2:
            raise ValueError(
                "You have set `multiclass=False`, but have more than 2 classes in your data,"
                " based on the C dimension of `preds`."
            )
        if not _is_traced() and target.numel() > 0 and target.max() >= implied_classes:
            raise ValueError(
                "The highest label in `target` should be smaller than the size of the `C` dimension of `preds`."
            )

    if num_classes:
        if case == DataType.BINARY:
            _check_num_classes_binary(num_classes, multiclass)
        elif case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS):
            _check_num_classes_mc(preds, target, num_classes, multiclass, implied_classes)
        elif case == DataType.MULTILABEL:
            _check_num_classes_ml(num_classes, multiclass, implied_classes)

    if top_k is not None:
        _check_top_k(top_k, case, implied_classes, multiclass, _is_floating(preds))

    return case


def _input_squeeze(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Remove all size-1 dims except the batch dim."""
    if preds.shape and preds.shape[0] == 1:
        preds = preds.squeeze().unsqueeze(0)
        target = target.squeeze().unsqueeze(0)
    else:
        preds, target = preds.squeeze(), target.squeeze()
    return preds, target


def _input_format_classification(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, DataType]:
    """Canonicalize any accepted classification layout to binary int32 tensors
    of shape ``(N, C)`` or ``(N, C, X)``, plus the detected :class:`DataType`."""
    preds, target = _input_squeeze(preds, target)
    if preds.dtype in (torch.bfloat16, torch.float16):
        preds = preds.float()

    case = _check_classification_inputs(
        preds,
        target,
        threshold=threshold,
        num_classes=num_classes,
        multiclass=multiclass,
        top_k=top_k,
        ignore_index=ignore_index,
    )

    if case in (DataType.BINARY, DataType.MULTILABEL) and not top_k:
        preds = (preds >= threshold).to(torch.int32)
        num_classes = num_classes if not multiclass else 2

    if case == DataType.MULTILABEL and top_k:
        preds = select_topk(preds, top_k)

    if case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) or multiclass:
        if _is_floating(preds):
            num_classes = preds.shape[1]
            preds = select_topk(preds, top_k or 1)
        else:
            if num_classes is None:
                if multiclass is False:
                    # multiclass=False certifies binary {0,1} data
                    num_classes = 2
                elif _is_traced():
                    raise ValueError(
                        "`num_classes` must be given when formatting integer multi-class "
                        "inputs under jit (cannot infer the class count from traced values)."
                    )
                else:
                    num_classes = int(max(preds.max(), target.max())) + 1
            preds = to_onehot(preds, max(2, num_classes))

        target = to_onehot(target, max(2, int(num_classes)))

        if multiclass is False:
            preds, target = preds[:, 1, ...], target[:, 1, ...]

    if not _check_for_empty_tensors(preds, target):
        if (case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) and multiclass is not False) or multiclass:
            target = target.reshape(target.shape[0], target.shape[1], -1)
            preds = preds.reshape(preds.shape[0], preds.shape[1], -1)
        else:
            target = target.reshape(target.shape[0], -1)
            preds = preds.reshape(preds.shape[0], -1)

    if preds.ndim > 2 and preds.shape[-1] == 1:
        preds, target = preds.squeeze(-1), target.squeeze(-1)

    return preds.to(torch.int32), target.to(torch.int32), case


def _check_retrieval_functional_inputs(
    preds: Tensor,
    target: Tensor,
    allow_non_binary_target: bool = False,
) -> Tuple[Tensor, Tensor]:
    """Validate retrieval functional inputs; multi-dim inputs are flattened
    (only empty or 0-d tensors are rejected)."""
    if preds.shape != target.shape:
        raise ValueError("`preds` and `target` must be of the same shape")
    if preds.numel() == 0 or preds.ndim == 0:
        raise ValueError("`preds` and `target` must be non-empty and non-scalar tensors")
    return _check_retrieval_target_and_prediction_types(preds, target, allow_non_binary_target)


def _check_retrieval_inputs(
    indexes: Tensor,
    preds: Tensor,
    target: Tensor,
    allow_non_binary_target: bool = False,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Validate retrieval module inputs; rows whose target equals
    ``ignore_index`` are dropped (a boolean index, so one host sync)."""
    if indexes.shape != preds.shape or preds.shape != target.shape:
        raise ValueError("`indexes`, `preds` and `target` must be of the same shape")
    if not _is_integer(indexes):
        raise ValueError("`indexes` must be a tensor of integers")
    if ignore_index is not None and not _is_traced():
        valid = target != ignore_index
        indexes, preds, target = indexes[valid], preds[valid], target[valid]
    if indexes.numel() == 0 or indexes.ndim == 0:
        raise ValueError("`indexes`, `preds` and `target` must be non-empty and non-scalar tensors")
    preds, target = _check_retrieval_target_and_prediction_types(preds, target, allow_non_binary_target)
    return indexes.reshape(-1).to(torch.int32), preds, target


def _check_retrieval_target_and_prediction_types(
    preds: Tensor,
    target: Tensor,
    allow_non_binary_target: bool,
) -> Tuple[Tensor, Tensor]:
    """Targets may be bool, integer or float; binary-relevance metrics also
    require values in [0, 1]. Scores become float32 (the JAX package's dtype
    with x64 off); the target keeps its dtype."""
    if target.is_complex():
        raise ValueError("`target` must be a tensor of booleans, integers or floats")
    if not _is_floating(preds):
        raise ValueError("`preds` must be a tensor of floats")
    # one host read for both bounds
    if (not allow_non_binary_target and not _is_traced() and target.numel()
            and bool((target.max() > 1) | (target.min() < 0))):
        raise ValueError("`target` must contain `binary` values")
    return preds.reshape(-1).to(torch.float32), target.reshape(-1)
