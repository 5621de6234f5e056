"""FID-evaluation traffic: synthetic uint8 images made on the device from a seed.

The configuration gives the evaluation's sizes (``images`` generated, ``real_images``, ``height`` x
``width``), the mix (``portbench/mixes/<name>.json``) how they are batched and drawn.

An image is a smooth random field: for each octave ``(cells, weight)`` of the mix's ``octaves``, a
``3 x cells x cells`` grid of standard normals resized bilinearly to the image's size and weighted,
summed, then ``127.5 + contrast * field`` rounded and clamped to [0, 255]. The generated side is blurred
(a ``blur`` x ``blur`` box) and gets ``noise`` times a standard normal a pixel before the rounding, so that
its statistics differ from the real side's and FID stays well above 0.

Mix keys: ``batch`` (images an update; the epoch's last update takes the rest), ``octaves``,
``contrast``, ``blur``, ``noise``.
"""
from typing import Dict, Iterator, List

import torch
import torch.nn.functional as F
from torch import Tensor

REAL_STREAM = 2**62  # the real side's generator seed is the run's seed plus this
CHUNK = 500  # images made at a time


class Geometry:
    """The epoch's shape: ``sizes[u]`` generated images in update ``u``; the real side in the same sizes."""

    def __init__(self, config: Dict, mix: Dict) -> None:
        self.images, self.real_images = config["images"], config["real_images"]
        self.height, self.width = config["height"], config["width"]
        self.batch = mix["batch"]
        self.sizes = self._sizes(self.images)
        self.real_sizes = self._sizes(self.real_images)

    def _sizes(self, images: int) -> List[int]:
        full, last = divmod(images, self.batch)
        return [self.batch] * full + ([last] if last else [])


def _images(g: torch.Generator, mix: Dict, n: int, height: int, width: int, generated: bool) -> Tensor:
    device = g.device
    field = torch.zeros(n, 3, height, width, device=device)
    for cells, weight in mix["octaves"]:
        grid = torch.randn(n, 3, cells, cells, generator=g, device=device)
        field += weight * F.interpolate(grid, size=(height, width), mode="bilinear", align_corners=False)
    x = 127.5 + mix["contrast"] * field
    if generated:
        k = mix["blur"]
        x = F.avg_pool2d(x, k, 1, k // 2, count_include_pad=False)
        x += mix["noise"] * torch.randn(x.shape, generator=g, device=device)
    return x.round_().clamp_(0, 255).to(torch.uint8)


def make_pool(geometry: Geometry, mix: Dict, seed: int, device: torch.device) -> Tensor:
    """The generated images of an epoch, uint8 ``(images, 3, H, W)``, from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    pool = torch.empty(geometry.images, 3, geometry.height, geometry.width, dtype=torch.uint8, device=device)
    for start in range(0, geometry.images, CHUNK):
        n = min(CHUNK, geometry.images - start)
        pool[start:start + n] = _images(g, mix, n, geometry.height, geometry.width, generated=True)
    return pool


def real_batches(geometry: Geometry, mix: Dict, seed: int, device: torch.device) -> Iterator[Tensor]:
    """The real side's uint8 batches, in update order, each made when it is asked for, from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed + REAL_STREAM)
    for n in geometry.real_sizes:
        yield _images(g, mix, n, geometry.height, geometry.width, generated=False)


def update_batches(pool: Tensor, geometry: Geometry) -> Iterator[Tensor]:
    """The generated side's batches of an epoch, in update order: consecutive slices of the pool."""
    start = 0
    for n in geometry.sizes:
        yield pool[start:start + n]
        start += n
