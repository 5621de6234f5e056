"""Dice score: port of ``metrics_tpu/functional/classification/dice.py``.

The per-class true positives, false positives and false negatives come from
one ``(C', N)`` comparison against every class at once (no loop over classes).
"""
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.utilities.data import to_categorical
from metrics_tpu_torch.utilities.distributed import reduce


def _dice_counts(preds: Tensor, target: Tensor, bg: bool = False):
    """Each class's ``(tp, fp, fn)`` as float32, and whether the target has it."""
    num_classes = preds.shape[1]
    bg_inv = 1 - int(bg)

    if preds.ndim == target.ndim + 1:
        preds_lbl = to_categorical(preds, argmax_dim=1)
    else:
        preds_lbl = preds

    classes = torch.arange(bg_inv, num_classes, device=preds.device)
    pred_is_c = preds_lbl.reshape(-1)[None, :] == classes[:, None]
    target_is_c = target.reshape(-1)[None, :] == classes[:, None]

    tp = (pred_is_c & target_is_c).sum(dim=1).to(torch.float32)
    fp = (pred_is_c & ~target_is_c).sum(dim=1).to(torch.float32)
    fn = (~pred_is_c & target_is_c).sum(dim=1).to(torch.float32)
    return tp, fp, fn, target_is_c.any(dim=1)


def dice_score(
    preds: Tensor,
    target: Tensor,
    bg: bool = False,
    nan_score: float = 0.0,
    no_fg_score: float = 0.0,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """Dice score from prediction scores.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import dice_score
        >>> pred = torch.tensor([[0.85, 0.05, 0.05, 0.05],
        ...                      [0.05, 0.85, 0.05, 0.05],
        ...                      [0.05, 0.05, 0.85, 0.05],
        ...                      [0.05, 0.05, 0.05, 0.85]])
        >>> target = torch.tensor([0, 1, 3, 2])
        >>> round(float(dice_score(pred, target)), 4)
        0.3333
    """
    tp, fp, fn, has_fg = _dice_counts(preds, target, bg)

    denom = 2 * tp + fp + fn
    score = torch.where(denom != 0, 2 * tp / torch.where(denom == 0, 1.0, denom), nan_score)
    scores = torch.where(has_fg, score, no_fg_score)

    return reduce(scores, reduction=reduction)
