"""Hinge loss: port of ``metrics_tpu/functional/classification/hinge.py``."""
from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utilities.checks import _input_squeeze
from metrics_tpu_torch.utilities.data import to_onehot
from metrics_tpu_torch.utilities.enums import DataType, EnumStr


class MulticlassMode(EnumStr):
    """The multiclass flavours of the hinge loss."""

    CRAMMER_SINGER = "crammer-singer"
    ONE_VS_ALL = "one-vs-all"


def _check_shape_and_type_consistency_hinge(preds: Tensor, target: Tensor) -> DataType:
    """Binary for ``(N,)`` scores, multiclass for ``(N, C)``; ``target`` is ``(N,)``."""
    if target.ndim > 1:
        raise ValueError(f"The `target` should be one dimensional, got `target` with shape={tuple(target.shape)}.")
    if preds.ndim == 1:
        if preds.shape != target.shape:
            raise ValueError(
                "The `preds` and `target` should have the same shape,"
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
        mode = DataType.BINARY
    elif preds.ndim == 2:
        if preds.shape[0] != target.shape[0]:
            raise ValueError(
                "The `preds` and `target` should have the same shape in the first dimension,"
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
        mode = DataType.MULTICLASS
    else:
        raise ValueError(f"The `preds` should be one or two dimensional, got `preds` with shape={tuple(preds.shape)}.")
    return mode


def _hinge_update(
    preds: Tensor,
    target: Tensor,
    squared: bool = False,
    multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
) -> Tuple[Tensor, Tensor]:
    """The sum of the observations' hinge losses, and their count."""
    preds, target = _input_squeeze(preds, target)
    mode = _check_shape_and_type_consistency_hinge(preds, target)

    if mode == DataType.MULTICLASS:
        target_oh = to_onehot(target, max(2, preds.shape[1])).bool()

    if mode == DataType.MULTICLASS and (multiclass_mode is None or multiclass_mode == MulticlassMode.CRAMMER_SINGER):
        # the margin: the true class's score less the best score among the others
        margin = torch.sum(torch.where(target_oh, preds, 0.0), dim=1)
        margin = margin - torch.amax(torch.where(target_oh, -torch.inf, preds), dim=1)
    elif mode == DataType.BINARY or multiclass_mode == MulticlassMode.ONE_VS_ALL:
        if mode == DataType.BINARY:
            target_b = target.bool()
        else:
            target_b = target_oh
        margin = torch.where(target_b, preds, -preds)
    else:
        raise ValueError(
            "The `multiclass_mode` should be either None / 'crammer-singer' / MulticlassMode.CRAMMER_SINGER"
            "(default) or 'one-vs-all' / MulticlassMode.ONE_VS_ALL,"
            f" got {multiclass_mode}."
        )

    measures = torch.clamp(1 - margin, min=0)
    if squared:
        measures = measures**2

    # a fill on the device: a tensor made from a Python number would be a host-to-device copy, a sync on the card
    total = torch.full((), target.shape[0], dtype=torch.int32, device=preds.device)
    return measures.sum(dim=0), total


def _hinge_compute(measure: Tensor, total: Tensor) -> Tensor:
    """The mean hinge loss."""
    return measure / total


def hinge_loss(
    preds: Tensor,
    target: Tensor,
    squared: bool = False,
    multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
) -> Tensor:
    """Mean hinge loss, as used for SVMs.

    Example (binary):
        >>> import torch
        >>> from metrics_tpu_torch.functional import hinge_loss
        >>> target = torch.tensor([0, 1, 1])
        >>> preds = torch.tensor([-2.2, 2.4, 0.1])
        >>> round(float(hinge_loss(preds, target)), 4)
        0.3
    """
    measure, total = _hinge_update(preds, target, squared=squared, multiclass_mode=multiclass_mode)
    return _hinge_compute(measure, total)
