"""The LPIPS network (AlexNet / VGG16 / SqueezeNet 1.1 backbones) as a
``torch.nn`` module: port of ``metrics_tpu/image/lpips_net.py``.

Images in [-1, 1] pass the ImageNet scaling layer and a backbone tapped after
five ReLU stages (seven for SqueezeNet); each tap is unit-normalised over its
channels, the squared difference of the two images' taps goes through a
bias-free 1x1 ``lin`` head, is averaged over the pixels, and the taps' scores
are summed.

Modules carry the ``lpips`` package's names as
``tools/convert_lpips_weights.py`` reads them: the backbone is ``net``,
indexed as torchvision's ``features`` (``net.0.weight``, ``net.3.squeeze.weight``),
the heads ``lin{i}.model.1.weight``. The JAX package's flat ``.npz`` crosses
both ways through :meth:`~metrics_tpu_torch.image.inception_net.FlatParams.load_flat`
and ``flat_params``. PyTorch checkpoints load without the JAX package: a
torchvision ``features`` state dict and the lpips heads' checkpoint, a
pair of ``.pth`` files, are checked key by key and shape by shape and
loaded with ``load_state_dict(strict=True)``; :func:`convert_torch_state_dict`
gives the bytes of ``tools/convert_lpips_weights.py``
(``tools/torch_convert_lpips_weights.py``); without weights the network takes the seeded init of
:func:`~metrics_tpu_torch.image.inception_net.seeded_init_` with the heads'
weights made non-negative, as lpips keeps them (not calibrated perceptual
scores, but distances: 0 for identical images and never negative).
"""
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from metrics_tpu_torch.functional.image.helper import _full_float32
from metrics_tpu_torch.image.inception_net import FlatParams, _is_nchw, load_params, load_torch, seeded_init_
from metrics_tpu_torch.utilities.prints import rank_zero_warn

# ImageNet scaling layer (lpips.ScalingLayer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# torchvision features index of each conv, in tap order -> flax Conv_i
_BACKBONE_CONVS = {"alex": [0, 3, 6, 8, 10], "vgg": [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]}
# torchvision squeezenet1_1 features index of each fire module -> flax Fire_i
_SQUEEZE_FIRES = [3, 4, 6, 7, 9, 10, 11, 12]
_TRUNK_NAME = {"alex": "AlexNetFeatures_0", "vgg": "VGG16Features_0", "squeeze": "SqueezeNetFeatures_0"}
# features indices whose outputs are the taps (the lpips package's slices)
_TAPS = {"alex": (1, 4, 7, 9, 11), "vgg": (3, 8, 15, 22, 29), "squeeze": (1, 4, 7, 9, 10, 11, 12)}
_TAP_WIDTHS = {"alex": (64, 192, 384, 256, 256), "vgg": (64, 128, 256, 512, 512),
               "squeeze": (64, 128, 256, 384, 384, 512, 512)}


class Fire(nn.Module):
    """SqueezeNet's fire module: a 1x1 squeeze, then 1x1 and 3x3 expands side by side."""

    def __init__(self, cin: int, squeeze: int, expand: int) -> None:
        super().__init__()
        self.squeeze = nn.Conv2d(cin, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x: Tensor) -> Tensor:
        s = F.relu(_conv(self.squeeze, x))
        return torch.cat([F.relu(_conv(self.expand1x1, s)), F.relu(_conv(self.expand3x3, s))], dim=1)


def _conv(conv: nn.Conv2d, x: Tensor) -> Tensor:
    """``conv`` in the dtype of ``x`` (the weights cast on the fly)."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, conv.stride, conv.padding)


def _features(net_type: str) -> nn.Sequential:
    """torchvision's ``features`` of the backbone, up to its last tap."""
    relu = nn.ReLU
    if net_type == "alex":
        return nn.Sequential(nn.Conv2d(3, 64, 11, 4, 2), relu(), nn.MaxPool2d(3, 2), nn.Conv2d(64, 192, 5, padding=2),
                             relu(), nn.MaxPool2d(3, 2), nn.Conv2d(192, 384, 3, padding=1), relu(),
                             nn.Conv2d(384, 256, 3, padding=1), relu(), nn.Conv2d(256, 256, 3, padding=1), relu())
    if net_type == "vgg":
        layers: List[nn.Module] = []
        cin = 3
        for stage, (width, convs) in enumerate(((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))):
            if stage:
                layers.append(nn.MaxPool2d(2, 2))
            for _ in range(convs):
                layers += [nn.Conv2d(cin, width, 3, padding=1), relu()]
                cin = width
        return nn.Sequential(*layers)

    def ceil_pool():
        return nn.MaxPool2d(3, 2, ceil_mode=True)

    return nn.Sequential(nn.Conv2d(3, 64, 3, 2), relu(), ceil_pool(), Fire(64, 16, 64), Fire(128, 16, 64), ceil_pool(),
                         Fire(128, 32, 128), Fire(256, 32, 128), ceil_pool(), Fire(256, 48, 192), Fire(384, 48, 192),
                         Fire(384, 64, 256), Fire(512, 64, 256))


class _Lin(nn.Module):
    """A tap's head: lpips' ``NetLinLayer`` (dropout, then a 1x1 conv to one channel, no bias)."""

    def __init__(self, cin: int) -> None:
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(cin, 1, 1, bias=False))


class _LPIPSModule(FlatParams):
    """Scaling layer, backbone and the taps' heads on normalised squared differences."""

    def __init__(self, net_type: str = "alex") -> None:
        super().__init__()
        self.net_type = net_type
        self.net = _features(net_type)
        for i, width in enumerate(_TAP_WIDTHS[net_type]):
            self.add_module(f"lin{i}", _Lin(width))
        seeded_init_(self)
        self.requires_grad_(False)  # frozen weights; gradients still reach the images
        for i in range(len(_TAP_WIDTHS[net_type])):  # lpips keeps its heads non-negative: a distance stays >= 0
            getattr(self, f"lin{i}").model[1].weight.abs_()
        # float64, each cast to the compute dtype as the JAX package rounds the Python constants
        self.register_buffer("shift", torch.tensor(_SHIFT, dtype=torch.float64).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE, dtype=torch.float64).reshape(1, 3, 1, 1), persistent=False)

    def _flax_key(self, name: str) -> Optional[str]:
        parts = name.split(".")
        if parts[0].startswith("lin"):
            return f"params/{parts[0]}/kernel"
        trunk, leaf = _TRUNK_NAME[self.net_type], "kernel" if parts[-1] == "weight" else "bias"
        idx = int(parts[1])
        if self.net_type == "squeeze":
            sub = "Conv_0" if idx == 0 else f"Fire_{_SQUEEZE_FIRES.index(idx)}/{parts[2]}"
        else:
            sub = f"Conv_{_BACKBONE_CONVS[self.net_type].index(idx)}"
        return f"params/{trunk}/{sub}/{leaf}"

    def _taps(self, x: Tensor) -> List[Tensor]:
        taps, wanted = [], _TAPS[self.net_type]
        for i, layer in enumerate(self.net):
            x = _conv(layer, x) if isinstance(layer, nn.Conv2d) else layer(x)
            if i in wanted:
                taps.append(x)
        return taps

    def forward(self, img1: Tensor, img2: Tensor) -> Tensor:
        dt = img1.dtype
        shift, scale = self.shift.to(dt), self.scale.to(dt)
        taps1 = self._taps((img1 - shift) / scale)
        taps2 = self._taps((img2 - shift) / scale)
        total = 0.0
        for i, (t1, t2) in enumerate(zip(taps1, taps2)):
            n1 = t1 * torch.rsqrt(torch.sum(t1**2, dim=1, keepdim=True) + 1e-10)
            n2 = t2 * torch.rsqrt(torch.sum(t2**2, dim=1, keepdim=True) + 1e-10)
            score = _conv(getattr(self, f"lin{i}").model[1], (n1 - n2) ** 2)
            total = total + score.mean(dim=(1, 2, 3))
        return total.to(torch.promote_types(dt, torch.float32))


def convert_torch_state_dict(backbone: Dict[str, Any], lins: Dict[str, Any], net_type: str) -> Dict[str, np.ndarray]:
    """The two PyTorch checkpoints as the JAX package's flat tree, byte for
    byte what ``tools/convert_lpips_weights.py`` makes of them (the backbone's
    convolutions in tap order, then the heads), after every key and shape is
    checked against the module (an abort names every difference)."""
    module = _LPIPSModule(net_type)
    state = {**{f"net.{k}": v for k, v in backbone.items()}, **lins}  # the backbone under ``net.``
    module.check_torch_state_dict(state)
    names = module._flax_names()  # flax key -> state name, in the module's (the converter's) order
    return module.torch_to_flat({names[key]: state[names[key]] for key in names})


def _load_weights(module: "_LPIPSModule", weights_path: Union[str, Sequence[str]]) -> None:
    if isinstance(weights_path, (list, tuple)):
        backbone, lins = (load_torch(p) for p in weights_path)
        module.load_torch_state_dict({**{f"net.{k}": v for k, v in backbone.items()}, **lins})
    else:
        module.load_flat(load_params(weights_path))


class LPIPSNet(nn.Module):
    """``(img1, img2) -> (N,)`` perceptual distances of ``(N, 3, H, W)`` or
    ``(N, H, W, 3)`` images in [-1, 1].

    Args:
        net_type: ``'alex'``, ``'vgg'`` or ``'squeeze'``.
        weights_path: a flax ``.npz`` of the network (the JAX package's
            layout) or a pair of ``.pth`` files (torchvision ``features``,
            lpips heads); None takes the seeded init.
        dtype: the compute dtype; scores come back in float32 or wider.
    """

    def __init__(self, net_type: str = "alex", weights_path: Optional[Union[str, Sequence[str]]] = None,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        if net_type not in ("alex", "vgg", "squeeze"):
            raise ValueError(f"Argument `net_type` must be 'alex', 'vgg' or 'squeeze', got {net_type}")
        self.dtype = dtype
        self.net = _LPIPSModule(net_type)
        if weights_path is not None:
            _load_weights(self.net, weights_path)
        else:
            rank_zero_warn(
                "LPIPSNet built without `weights_path`: the backbone is randomly initialized,"
                " so distances are NOT calibrated perceptual scores. Load pretrained weights"
                " for publishable LPIPS values (see docs/pretrained_weights.md)."
            )

    def forward(self, img1: Tensor, img2: Tensor) -> Tensor:
        if not _is_nchw(img1):
            img1, img2 = img1.permute(0, 3, 1, 2), img2.permute(0, 3, 1, 2)
        with _full_float32():
            return self.net(img1.to(self.dtype), img2.to(self.dtype))
