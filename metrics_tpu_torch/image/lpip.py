"""Learned Perceptual Image Patch Similarity: port of ``metrics_tpu/image/lpip.py``.

With ``net=None`` the metric builds the bundled
:class:`~metrics_tpu_torch.image.lpips_net.LPIPSNet` for ``net_type``
(``weights_path=`` loads a flax ``.npz`` or a pair of ``.pth`` files:
:class:`~metrics_tpu_torch.image.lpips_net.LPIPSNet`); any callable ``(img1, img2) ->
(N,)`` distances may stand in for it. The sums are float32 states; the
value is differentiable through autograd with respect to the images.
"""
from typing import Any, Callable, Optional, Sequence, Union

import torch
from torch import Tensor, nn

from metrics_tpu_torch.metric import Metric


class LearnedPerceptualImagePatchSimilarity(Metric):
    """The mean (or sum) of the per-pair perceptual distances.

    Args:
        net: a callable ``(img1, img2) -> (N,)`` distances (an ``nn.Module``
            moves with the metric); it takes precedence over ``net_type``.
        net_type: ``'alex'``, ``'vgg'`` or ``'squeeze'``: the bundled network.
        weights_path: the bundled network's weights: a flax ``.npz`` or a
            pair of ``.pth`` files (torchvision ``features``, lpips heads).
        reduction: ``'mean'`` or ``'sum'`` over the accumulated pairs.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import LearnedPerceptualImagePatchSimilarity
        >>> l2_net = lambda a, b: torch.square(a - b).mean(dim=(1, 2, 3))
        >>> lpips = LearnedPerceptualImagePatchSimilarity(net=l2_net, device="cpu")
        >>> g = torch.Generator().manual_seed(0)
        >>> img1, img2 = torch.rand(4, 3, 8, 8, generator=g), torch.rand(4, 3, 8, 8, generator=g)
        >>> float(lpips(img1, img2)) > 0
        True
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        net: Optional[Callable[[Tensor, Tensor], Tensor]] = None,
        net_type: str = "alex",
        weights_path: Optional[Union[str, Sequence[str]]] = None,
        reduction: str = "mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if net is None:
            from metrics_tpu_torch.image.lpips_net import LPIPSNet

            net = LPIPSNet(net_type=net_type, weights_path=weights_path)
        if isinstance(net, nn.Module):
            net = net.to(self.device)
            self._device_attributes = ("net",)
        self.net = net
        valid_reduction = ("mean", "sum")
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction} but got {reduction}")
        self.reduction = reduction

        self.add_state("sum_scores", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, img1: Tensor, img2: Tensor) -> None:
        loss = self.net(img1, img2)
        self.sum_scores = self.sum_scores + loss.sum()
        self.total = self.total + loss.shape[0]

    def compute(self) -> Tensor:
        if self.reduction == "mean":
            return self.sum_scores / self.total
        return self.sum_scores
