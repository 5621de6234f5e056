"""Plain reference of semantic-segmentation evaluation, and its control one precision down.

Plain PyTorch, on whatever device the inputs live; it imports nothing of the program under test.

* Confusion matrix: rows by target class, columns by predicted class, exact int64 counts
  (``bincount`` of ``target * C + pred``). A score map predicts its first largest channel.
* mIoU, as ``JaccardIndex(num_classes=C, ignore_index=void, absent_score=0)`` defines it: the void's
  target row cleared, each class's IoU = diag / (column sum + row sum - diag), 0 where that union is 0,
  the mean over every class but the void.
* aAcc, mmsegmentation's pixel accuracy (``Accuracy(ignore_index=void, mdmc_average="global")``):
  the pixels predicted right over the pixels whose target is not the void.

The control computes the same one precision below what the configuration states: float32 scores
and float32 values in bfloat16, exact integer counts accumulated in float32.
"""
from typing import Sequence, Tuple

import torch
from torch import Tensor

CONTROL_SCORES = torch.bfloat16
CONTROL_COUNTS = torch.float32
CONTROL_VALUES = torch.bfloat16


def predicted(scores: Tensor, dtype: torch.dtype = torch.float32) -> Tensor:
    """``(n, H, W)`` class map of ``(n, C, H, W)`` scores taken in ``dtype``."""
    return scores.to(dtype).argmax(dim=1)


def image_confmats(target: Tensor, pred: Tensor, num_classes: int) -> Tensor:
    """``(n, C, C)`` int64 confusion matrices, one an image, of ``(n, H, W)`` class maps."""
    out = torch.empty((target.shape[0], num_classes, num_classes), dtype=torch.int64, device=target.device)
    for i in range(target.shape[0]):  # an image at a time: the flat index stays small
        flat = target[i].reshape(-1).long() * num_classes + pred[i].reshape(-1).long()
        out[i] = torch.bincount(flat, minlength=num_classes * num_classes).reshape(num_classes, num_classes)
    return out


def accumulate(parts: Sequence[Tensor], dtype: torch.dtype = torch.int64) -> Tensor:
    """The sum of per-update matrices in update order, accumulated in ``dtype``."""
    total = torch.zeros_like(parts[0], dtype=dtype)
    for part in parts:
        total = total + part.to(dtype)
    return total


def miou_aacc(confmat: Tensor, void: int, dtype: torch.dtype = torch.float64) -> Tuple[float, float]:
    """mIoU and aAcc of one accumulated confusion matrix, computed in ``dtype``."""
    cm = confmat.to(dtype)
    keep = torch.arange(cm.shape[0], device=cm.device) != void
    rows = cm.clone()
    rows[void] = 0
    inter = torch.diagonal(rows)
    union = rows.sum(dim=0) + rows.sum(dim=1) - inter
    iou = torch.where(union > 0, inter / torch.where(union > 0, union, torch.ones_like(union)), torch.zeros_like(union))
    miou = iou[keep].mean()
    aacc = torch.diagonal(cm)[keep].sum() / cm[keep].sum()
    return float(miou), float(aacc)
