"""Segmentation-evaluation traffic, made on the device from a seed.

One generator for every segmentation mix: the configuration gives the val set's geometry and label
statistics, the mix (``portbench/mixes/<name>.json``) what the user hands the metric each update.

Labels (a frozen copy of the label-map recipe of the repository's card smoke run): a class a
``patch`` x ``patch`` square, drawn with shares proportional to ``(k + 1) ** -zipf`` over the
evaluated classes, ``void_share`` of the squares the void. A prediction equals the target on
``right_share`` of the non-void pixels and is drawn from the same shares elsewhere; it is never the void.

Mix keys:

* ``inputs``: ``"scores"`` (float32 ``(B, C, H, W)``) or ``"labels"`` (int64 ``(B, H, W)``); the
  target is int64 ``(B, H, W)`` in both.
* ``updates_per_epoch``: the val set in that many updates, ``B = ceil(images / updates)`` images
  each and the remainder in the last.
* ``pool_batches_max``, ``pool_bytes_max``: the pool of distinct batches cycled through, as many as
  both allow.
* ``right_share``; for scores ``score_margin`` and ``score_noise``: a pixel's scores are
  ``noise * N(0, 1)``, ``margin`` added to the predicted class, clamped to [-8, 8] and put on a
  2**-10 grid, plus ``c * 2**-18`` on channel ``c`` so that no two channels tie; the void's channel is -16.
"""
from typing import Dict, List, Tuple

import torch
from torch import Tensor

GRID = 2.0**-10
CHANNEL_STEP = 2.0**-18
SCORE_CLAMP = 8.0
VOID_SCORE = -16.0


class Geometry:
    """The epoch's shape: ``sizes[u]`` images in update ``u``, ``pool`` distinct batches of ``batch`` images."""

    def __init__(self, config: Dict, mix: Dict) -> None:
        self.images, self.height, self.width = config["images"], config["height"], config["width"]
        self.num_classes, self.void = config["num_classes"], config["void"]
        if not 0 <= self.void < self.num_classes or self.num_classes * CHANNEL_STEP >= GRID:
            raise ValueError(f"unsupported classes: {self.num_classes} with void {self.void}")
        self.inputs = mix["inputs"]
        if self.inputs not in ("scores", "labels"):
            raise ValueError(f"mix inputs must be 'scores' or 'labels', got {self.inputs!r}")
        updates = mix["updates_per_epoch"]
        self.batch = -(-self.images // updates)
        last = self.images - self.batch * (updates - 1)
        if not 1 <= last <= self.batch:
            raise ValueError(f"{self.images} images do not make {updates} updates")
        self.sizes = [self.batch] * (updates - 1) + [last]
        self.pool = max(1, min(mix["pool_batches_max"], int(mix["pool_bytes_max"] // self.batch_bytes(self.batch))))

    @property
    def pixels(self) -> int:
        return self.height * self.width

    def batch_bytes(self, images: int) -> int:
        """Bytes of what the user hands one update of ``images`` images: preds and target."""
        preds = self.num_classes * 4 if self.inputs == "scores" else 8
        return images * self.pixels * (preds + 8)


def _shares_cdf(config: Dict, device: torch.device) -> Tensor:
    k = torch.arange(1, config["void"] + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(k ** -config["labels"]["zipf"], 0)
    return (cdf / cdf[-1]).float()


def _draw(g: torch.Generator, cdf: Tensor, shape: Tuple[int, ...]) -> Tensor:
    u = torch.rand(shape, generator=g, device=cdf.device)
    return torch.searchsorted(cdf, u).clamp_(max=cdf.shape[0] - 1)


def make_pool(config: Dict, mix: Dict, geometry: Geometry, seed: int, device: torch.device) -> List[Tuple[Tensor, Tensor]]:
    """``geometry.pool`` batches of ``(preds, target)``, each of ``geometry.batch`` images, from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    cdf = _shares_cdf(config, device)
    labels = config["labels"]
    patch, void, c = labels["patch"], geometry.void, geometry.num_classes
    b, h, w = geometry.batch, geometry.height, geometry.width
    if h % patch or w % patch:
        raise ValueError(f"{h} x {w} is not whole {patch}-pixel patches")
    pool = []
    for _ in range(geometry.pool):
        squares = _draw(g, cdf, (b, h // patch, 1, w // patch, 1))
        squares = torch.where(torch.rand(squares.shape, generator=g, device=device) < labels["void_share"], void, squares)
        target = squares.expand(-1, -1, patch, -1, patch).reshape(b, h, w).contiguous()
        right = (torch.rand((b, h, w), generator=g, device=device) < mix["right_share"]) & (target != void)
        pred = torch.where(right, target, _draw(g, cdf, (b, h, w)))
        del squares, right
        if geometry.inputs == "labels":
            pool.append((pred, target))
            continue
        scores = torch.randn((b, c, h, w), generator=g, device=device).mul_(mix["score_noise"])
        scores.scatter_add_(1, pred[:, None], torch.full((b, 1, h, w), float(mix["score_margin"]), device=device))
        del pred
        scores.clamp_(-SCORE_CLAMP, SCORE_CLAMP).div_(GRID).round_().mul_(GRID)
        scores.add_((torch.arange(c, device=device, dtype=torch.float32) * CHANNEL_STEP).view(1, c, 1, 1))
        scores[:, void] = VOID_SCORE
        pool.append((scores, target))
    return pool


def pool_bytes(pool: List[Tuple[Tensor, Tensor]]) -> int:
    return sum(t.numel() * t.element_size() for batch in pool for t in batch)


def update_batch(pool: List[Tuple[Tensor, Tensor]], geometry: Geometry, g: int, images: int) -> Tuple[Tensor, Tensor]:
    """The ``g``-th update's batch of the run: pool batch ``g mod pool``, its first ``images`` images."""
    preds, target = pool[g % len(pool)]
    if images == geometry.batch:
        return preds, target
    return preds[:images], target[:images]

