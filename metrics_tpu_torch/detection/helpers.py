"""Box utilities for the detection metrics: port of ``metrics_tpu/detection/helpers.py``.

Plain torch, no torchvision, with the JAX package's float32 arithmetic in
the same order, so a conversion is bit for bit its.
"""
import torch
from torch import Tensor


def box_convert(boxes: Tensor, in_fmt: str, out_fmt: str) -> Tensor:
    """Convert between 'xyxy', 'xywh' and 'cxcywh' box formats."""
    allowed = ("xyxy", "xywh", "cxcywh")
    if in_fmt not in allowed or out_fmt not in allowed:
        raise ValueError(f"Unsupported box format conversion {in_fmt} -> {out_fmt}")
    if in_fmt == out_fmt:
        return boxes

    if in_fmt == "xywh":
        x, y, w, h = boxes.unbind(-1)
        xyxy = torch.stack([x, y, x + w, y + h], dim=-1)
    elif in_fmt == "cxcywh":
        cx, cy, w, h = boxes.unbind(-1)
        xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    else:
        xyxy = boxes

    if out_fmt == "xyxy":
        return xyxy
    x1, y1, x2, y2 = xyxy.unbind(-1)
    if out_fmt == "xywh":
        return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


def box_area(boxes: Tensor) -> Tensor:
    """Area of xyxy boxes."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Pairwise IoU matrix between two xyxy box sets, (N, M)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)

    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0), 0.0)
