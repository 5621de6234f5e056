"""Image gradients: port of ``metrics_tpu/functional/image/gradients.py``."""
from typing import Tuple

import torch.nn.functional as F
from torch import Tensor


def _image_gradients_validate(img: Tensor) -> None:
    if not isinstance(img, Tensor):
        raise TypeError(f"The `img` expects a value of <Array> type but got {type(img)}")
    if img.ndim != 4:
        raise RuntimeError(f"The `img` expects a 4D tensor but got {img.ndim}D tensor")


def _compute_image_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    """One-step differences along the height and the width, zero at the far edge."""
    dy = img[..., 1:, :] - img[..., :-1, :]
    dx = img[..., :, 1:] - img[..., :, :-1]
    return F.pad(dy, (0, 0, 0, 1)), F.pad(dx, (0, 1, 0, 0))


def image_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    """``(dy, dx)`` of an ``(N, C, H, W)`` batch.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import image_gradients
        >>> image = torch.arange(0, 25, dtype=torch.float32).reshape(1, 1, 5, 5)
        >>> dy, dx = image_gradients(image)
        >>> dy[0, 0, :2, :2]
        tensor([[5., 5.],
                [5., 5.]])
    """
    _image_gradients_validate(img)
    return _compute_image_gradients(img)
