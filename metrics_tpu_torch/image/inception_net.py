"""The FID InceptionV3 as a ``torch.nn`` module: port of
``metrics_tpu/image/inception_net.py``.

The network of ``torch_fidelity``'s FID InceptionV3 (the JAX package's flax
module): the stem, the mixed blocks A-E, the 2048-d global pool and a 1,008-way
head, with the FID variant's pools (branch average pools that leave padding
out of the count, a max pool in Mixed_7c's pool branch). Submodules carry
``torch_fidelity``'s names (``Conv2d_1a_3x3``, ``Mixed_5b.branch1x1.conv``,
``fc``), so its state dict loads as it is.

Weights cross with the JAX package through its flat ``.npz``
(``params/...`` and ``batch_stats/...`` keys, HWIO kernels, ``(in, out)``
dense kernel): :func:`load_params` and :func:`save_params` read and write it
with numpy alone, and :meth:`InceptionV3.load_flat` /
:meth:`InceptionV3.flat_params` map it to and from the module's state dict
by the tables of ``tools/convert_inception_weights.py``, kept here. A file
read and written again is the same bytes.

A PyTorch checkpoint loads without the JAX package: ``weights_path=`` also
takes a ``.pth`` of ``torch_fidelity``'s (or torchvision's) state dict, read
with ``torch.load(weights_only=True)``, checked key by key and shape by
shape against the module (:meth:`FlatParams.load_torch_state_dict`) and
loaded with ``load_state_dict(strict=True)``; :func:`convert_torch_state_dict`
gives the same state dict as the JAX package's flat tree, the bytes of
``tools/convert_inception_weights.py`` (``tools/torch_convert_inception_weights.py``).

Without weights the network takes its own seeded init
(:func:`seeded_init_`, a ``torch.Generator`` seeded 0 on the CPU; the JAX
package's ``net.init(PRNGKey(0))`` cannot be rebuilt without flax), so values
are not comparable to published ones, nor to the JAX package's defaults.

The extractor runs the trunk at the size it is given unless ``resize=`` is
set: then an image of another size is first resized to ``resize x resize``
by TF1's ``resize_bilinear`` (:func:`resize_bilinear_tf1`), as
``torch_fidelity``'s FID extractor resizes every input to 299 x 299.

The forward runs in the dtype of its input (float32 by default; ``float64``
for parity runs; ``bfloat16`` as the JAX package's bf16 option: weights cast
on the fly, batch norm in float32); on the card in full float32 (TF32 off,
:func:`~metrics_tpu_torch.functional.image.helper._full_float32`). A failed
cuDNN call raises: there is no fallback.
"""
import math
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from metrics_tpu_torch import telemetry
from metrics_tpu_torch.functional.image.helper import _full_float32
from metrics_tpu_torch.ops import marks
from metrics_tpu_torch.utilities.prints import rank_zero_warn

# torch_fidelity module -> flax submodule (call order of the flax InceptionV3)
_TOP = {
    "Conv2d_1a_3x3": "BasicConv_0",
    "Conv2d_2a_3x3": "BasicConv_1",
    "Conv2d_2b_3x3": "BasicConv_2",
    "Conv2d_3b_1x1": "BasicConv_3",
    "Conv2d_4a_3x3": "BasicConv_4",
    "Mixed_5b": "InceptionA_0",
    "Mixed_5c": "InceptionA_1",
    "Mixed_5d": "InceptionA_2",
    "Mixed_6a": "InceptionB_0",
    "Mixed_6b": "InceptionC_0",
    "Mixed_6c": "InceptionC_1",
    "Mixed_6d": "InceptionC_2",
    "Mixed_6e": "InceptionC_3",
    "Mixed_7a": "InceptionD_0",
    "Mixed_7b": "InceptionE_0",
    "Mixed_7c": "InceptionE_1",
}
# branch -> BasicConv index within its flax block (call order)
_BRANCH = {
    "InceptionA": {"branch1x1": 0, "branch5x5_1": 1, "branch5x5_2": 2, "branch3x3dbl_1": 3, "branch3x3dbl_2": 4,
                   "branch3x3dbl_3": 5, "branch_pool": 6},
    "InceptionB": {"branch3x3": 0, "branch3x3dbl_1": 1, "branch3x3dbl_2": 2, "branch3x3dbl_3": 3},
    "InceptionC": {"branch1x1": 0, "branch7x7_1": 1, "branch7x7_2": 2, "branch7x7_3": 3, "branch7x7dbl_1": 4,
                   "branch7x7dbl_2": 5, "branch7x7dbl_3": 6, "branch7x7dbl_4": 7, "branch7x7dbl_5": 8,
                   "branch_pool": 9},
    "InceptionD": {"branch3x3_1": 0, "branch3x3_2": 1, "branch7x7x3_1": 2, "branch7x7x3_2": 3, "branch7x7x3_3": 4,
                   "branch7x7x3_4": 5},
    "InceptionE": {"branch1x1": 0, "branch3x3_1": 1, "branch3x3_2a": 2, "branch3x3_2b": 3, "branch3x3dbl_1": 4,
                   "branch3x3dbl_2": 5, "branch3x3dbl_3a": 6, "branch3x3dbl_3b": 7, "branch_pool": 8},
}
_PARAM = {  # torch tail -> (collection, flax leaf)
    "conv.weight": ("params", "Conv_0/kernel"),
    "bn.weight": ("params", "BatchNorm_0/scale"),
    "bn.bias": ("params", "BatchNorm_0/bias"),
    "bn.running_mean": ("batch_stats", "BatchNorm_0/mean"),
    "bn.running_var": ("batch_stats", "BatchNorm_0/var"),
}
_OUTPUTS = ("pool", "logits", "logits_unbiased", 64, 192, 768)


def _trunc_normal_(weight: Tensor, gain: float, g: torch.Generator) -> None:
    """A normal truncated at two deviations, of variance ``gain / fan_in``
    after the truncation (flax's variance-scaling initialisers), drawn by
    the inverse CDF of ``g``'s uniforms."""
    std = math.sqrt(gain / weight[0].numel()) / 0.87962566103423978
    edge = math.erf(2.0 / math.sqrt(2.0))
    with torch.no_grad():
        weight.uniform_(-edge, edge, generator=g).erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)


def seeded_init_(module: nn.Module) -> nn.Module:
    """Re-draw ``module``'s weights from a CPU generator seeded 0, in
    module order: convolution kernels He-normal (gain 2, so that activations
    keep their scale through the ReLUs), dense kernels lecun-normal, biases
    0, batch norms the identity."""
    g = torch.Generator().manual_seed(0)
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            _trunc_normal_(m.weight, 2.0 if isinstance(m, nn.Conv2d) else 1.0, g)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return module


def _hwio(kernel: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(kernel, (2, 3, 1, 0)))


def _oihw(kernel: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1)))


def load_params(npz_path: str) -> Dict[str, np.ndarray]:
    """The flat ``{'/'-joined path: array}`` tree of a flax ``.npz``
    (``metrics_tpu.image.inception_net.save_params``'s layout)."""
    with np.load(npz_path) as f:
        return {k: f[k] for k in f.files}


def load_torch(path: str) -> Dict[str, Tensor]:
    """The tensors of a ``.pth``/``.pt`` state dict (``weights_only``: no code runs)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(state, dict):
        raise ValueError(f"{path}: expected a state dict, got {type(state).__name__}")
    return {k: v for k, v in state.items() if isinstance(v, Tensor)}


def save_params(npz_path: str, flat: Dict[str, np.ndarray]) -> None:
    """Write a flat tree in the layout :func:`load_params` and the JAX
    package's ``load_params`` read: keys in the tree's order, arrays C-ordered."""
    np.savez(npz_path, **{k: np.ascontiguousarray(v) for k, v in flat.items()})


class FlatParams(nn.Module):
    """A module whose state dict maps one to one onto a flax tree through
    :meth:`_flax_key`; 4-D weights are convolution kernels (OIHW <-> HWIO) and
    2-D weights dense kernels (``(out, in)`` <-> ``(in, out)``)."""

    def _flax_key(self, name: str) -> Optional[str]:
        raise NotImplementedError

    def _flax_names(self) -> Dict[str, str]:
        names = {}
        for name in self.state_dict():
            key = self._flax_key(name)
            if key is not None:
                names[key] = name
        return names

    def flat_params(self) -> Dict[str, np.ndarray]:
        """The weights as the JAX package's flat tree: keys in the order of the
        tree they were loaded from (so that a file written again is the same
        bytes), else in flax's sorted order (``net.init``'s)."""
        state = self.state_dict()
        flat = {}
        for key, name in self._flax_names().items():
            value = state[name].detach().cpu().numpy()
            flat[key] = _hwio(value) if value.ndim == 4 else np.ascontiguousarray(value.T if value.ndim == 2 else value)
        order = getattr(self, "_flat_order", None) or sorted(flat)
        return {k: flat[k] for k in order}

    def _torch_kept(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """The entries of a PyTorch state dict that hold weights (the rest of
        the source network's layout is dropped here)."""
        return {k: v for k, v in state.items() if not k.endswith("num_batches_tracked")}

    def check_torch_state_dict(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """The weight entries of ``state``, after checking every key and
        shape against this module (the counterpart of the JAX tools' flax
        ``eval_shape`` check); raises ``ValueError`` with the full diff."""
        kept = self._torch_kept(state)
        own = self.state_dict()
        expected = {name: tuple(own[name].shape) for name in self._flax_names().values()}
        got = {k: tuple(v.shape) for k, v in kept.items()}
        missing, extra = sorted(set(expected) - set(got)), sorted(set(got) - set(expected))
        mismatched = [(k, got[k], expected[k]) for k in sorted(set(got) & set(expected)) if got[k] != expected[k]]
        if missing or extra or mismatched:
            raise ValueError(f"the state dict does not match {type(self).__name__}: missing {missing},"
                             f" unexpected {extra}, shape mismatches {mismatched}")
        return kept

    def load_torch_state_dict(self, state: Dict[str, Any]) -> "FlatParams":
        """Load a PyTorch state dict in the source network's layout: checked
        by :meth:`check_torch_state_dict`, then ``load_state_dict(strict=True)``
        (entries the module keeps and the file need not have, such as
        ``num_batches_tracked``, keep their values)."""
        new = dict(self.state_dict())
        own = dict(new)
        for k, v in self.check_torch_state_dict(state).items():
            new[k] = torch.as_tensor(v).to(own[k].dtype)
        self.load_state_dict(new, strict=True)
        self._flat_order = None
        return self

    def torch_to_flat(self, state: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """A checked PyTorch state dict as the JAX package's flat tree, in the
        state dict's order, float32, C-ordered: what the JAX package's
        converters write."""
        flat = {}
        for k, v in self.check_torch_state_dict(state).items():
            value = np.asarray(v.detach().cpu().numpy() if isinstance(v, Tensor) else v, dtype=np.float32)
            flat[self._flax_key(k)] = _hwio(value) if value.ndim == 4 else (
                np.ascontiguousarray(value.T) if value.ndim == 2 else value)
        return flat

    def load_flat(self, flat: Dict[str, np.ndarray]) -> "FlatParams":
        """Load the JAX package's flat tree; every key and shape must match.
        The tree's key order is kept for :meth:`flat_params`."""
        names = self._flax_names()
        state = self.state_dict()
        missing, extra = sorted(set(names) - set(flat)), sorted(set(flat) - set(names))
        if missing or extra:
            raise ValueError(
                f"the weights do not match {type(self).__name__}: missing {missing[:8]}, unexpected {extra[:8]}"
            )
        new = dict(state)
        for key, name in names.items():
            value = np.asarray(flat[key])
            value = _oihw(value) if value.ndim == 4 else (value.T if value.ndim == 2 else value)
            if tuple(value.shape) != tuple(state[name].shape):
                raise ValueError(f"{key}: shape {tuple(value.shape)} does not fit {name} {tuple(state[name].shape)}")
            new[name] = torch.from_numpy(np.ascontiguousarray(value)).to(state[name].dtype)
        self.load_state_dict(new)
        self._flat_order = list(flat)
        return self


class BasicConv2d(nn.Module):
    """A convolution without bias, eval batch norm (eps 1e-3), ReLU."""

    def __init__(self, cin: int, cout: int, kernel: Any, stride: int = 1, padding: Any = 0) -> None:
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: Tensor) -> Tensor:
        dt = x.dtype
        y = F.conv2d(x, self.conv.weight.to(dt), None, self.conv.stride, self.conv.padding)
        bn_dt = torch.promote_types(dt, torch.float32)
        bn = self.bn
        y = F.batch_norm(y.to(bn_dt), bn.running_mean.to(bn_dt), bn.running_var.to(bn_dt), bn.weight.to(bn_dt),
                         bn.bias.to(bn_dt), False, 0.0, bn.eps)
        return F.relu(y.to(dt))


def _avg_pool_same(x: Tensor) -> Tensor:
    """3x3 stride-1 average over the real pixels of each window."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x: Tensor) -> Tensor:
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool_same(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int) -> None:
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x: Tensor) -> Tensor:
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool_same(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int) -> None:
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionE(nn.Module):
    """``pool="max"`` is Mixed_7c of the FID network: a max pool (padded
    with -inf) in the pool branch where torchvision averages."""

    def __init__(self, cin: int, pool: str = "avg") -> None:
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        pooled = F.max_pool2d(x, 3, 1, 1) if self.pool == "max" else _avg_pool_same(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(pooled)], dim=1)


class InceptionV3(FlatParams):
    """The trunk: ``(N, 3, H, W)`` images (299 x 299 canonically, at least
    75 x 75) -> ``(pool features (N, 2048), logits (N, num_classes))``, both
    in float32 or wider; ``tap=64 / 192 / 768`` stops at that tap (after the
    first and second max pools, after Mixed_6e) and returns its map."""

    def __init__(self, num_classes: int = 1008) -> None:
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, pool="max")
        self.fc = nn.Linear(2048, num_classes)
        seeded_init_(self)
        self.requires_grad_(False)  # an evaluation network: no weight gradients, no saved activations

    def _torch_kept(self, state: Dict[str, Any]) -> Dict[str, Any]:
        # the auxiliary head is no part of the inference network
        return {k: v for k, v in super()._torch_kept(state).items() if not k.startswith("AuxLogits.")}

    def _flax_key(self, name: str) -> Optional[str]:
        if name == "fc.weight":
            return "params/Dense_0/kernel"
        if name == "fc.bias":
            return "params/Dense_0/bias"
        parts = name.split(".")
        tail = ".".join(parts[-2:])
        if tail not in _PARAM:  # num_batches_tracked
            return None
        collection, leaf = _PARAM[tail]
        top = _TOP[parts[0]]
        if len(parts) == 3:
            return f"{collection}/{top}/{leaf}"
        return f"{collection}/{top}/BasicConv_{_BRANCH[top.rsplit('_', 1)[0]][parts[1]]}/{leaf}"

    def forward(self, x: Tensor, tap: Optional[int] = None) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        if tap == 64:
            return x
        x = F.max_pool2d(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), 3, 2)
        if tap == 192:
            return x
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b, self.Mixed_6c,
                      self.Mixed_6d, self.Mixed_6e):
            x = block(x)
        if tap == 768:
            return x
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        dt = x.dtype
        features = x.mean(dim=(2, 3))
        logits = F.linear(features, self.fc.weight.to(dt), self.fc.bias.to(dt))
        out_dt = torch.promote_types(dt, torch.float32)
        return features.to(out_dt), logits.to(out_dt)


def resize_bilinear_tf1(x: Tensor, size: int) -> Tensor:
    """``(N, C, H, W)`` resized to ``size x size`` by TF1's ``resize_bilinear``
    (``align_corners=False``, no half-pixel centres), as ``torch_fidelity``'s
    ``interpolate_bilinear_2d_like_tensorflow1x`` computes it: output pixel
    ``i`` reads the input at ``src = i * in / out`` (float32), between pixel
    ``floor(src)`` and the next one, the last pixel repeated past the edge,
    across the width first and then the height; in ``x``'s dtype."""
    for dim in (3, 2):
        n_in = x.shape[dim]
        src = torch.arange(size, dtype=torch.float32, device=x.device) * torch.tensor(n_in / size, dtype=torch.float32)
        lo = src.long()
        hi = (lo + 1).clamp_max(n_in - 1)
        frac = (src - lo.float()).to(x.dtype).view((1, 1, size, 1) if dim == 2 else (1, 1, 1, size))
        a, b = x.index_select(dim, lo), x.index_select(dim, hi)
        x = a + (b - a) * frac
    return x


def _is_nchw(imgs: Tensor) -> bool:
    """The JAX package's layout rule: channels first where dim 1 is 3 and the
    last dim is not."""
    return imgs.shape[1] == 3 and imgs.shape[-1] != 3


class InceptionV3FeatureExtractor(nn.Module):
    """``(N, 3, H, W)`` or ``(N, H, W, 3)`` images -> features.

    uint8 images in [0, 255] become float32 and, after the resize, ``x / 127.5 - 1``
    (``torch_fidelity`` takes ``(x - 128) / 128``; this is the JAX package's
    rule); float images are used as they are.

    Args:
        weights_path: a flax ``.npz`` (the JAX package's ``save_params``
            layout, or :func:`save_params`), or a ``.pth``/``.pt`` of
            ``torch_fidelity``'s state dict; None takes the seeded init.
        output: ``'pool'`` (2048-d; the int 2048 is an alias),
            ``'logits'``, ``'logits_unbiased'`` (the head without its bias),
            or a tap 64 / 192 / 768, each pooled to ``(N, C)``.
        num_classes: the head's width (1,008 for the FID network).
        dtype: the compute dtype (``torch.bfloat16`` for the bf16 option,
            ``torch.float64`` for parity runs); outputs are float32 or wider.
        resize: None runs the trunk at the images' own size (the JAX
            package's behaviour); a size resizes every image that is not
            ``resize x resize`` to it first (:func:`resize_bilinear_tf1`, on
            the float image, uint8 ones in [0, 255]): 299 is
            ``torch_fidelity``'s rule, which published FIDs follow.

    Each call counts its images in the telemetry counter ``extract:images``
    and those it resized in ``extract:resized``; inside a captured program
    the trunk opens the device phase ``extract``.
    """

    def __init__(
        self,
        weights_path: Optional[str] = None,
        output: Any = "pool",
        num_classes: int = 1008,
        dtype: torch.dtype = torch.float32,
        resize: Optional[int] = None,
    ) -> None:
        super().__init__()
        if resize is not None and not (isinstance(resize, int) and resize >= 75):
            raise ValueError(f"Argument `resize` must be None or an int of at least 75, got {resize}")
        self.resize = resize
        if isinstance(output, np.integer):
            output = int(output)
        if output == 2048:
            output = "pool"
        if output not in _OUTPUTS:
            raise ValueError(
                f"Argument `output` (metric-ctor `feature`) must be one of {_OUTPUTS}"
                f" or 2048 (alias of 'pool'), got {output}"
            )
        self.output = output
        self.dtype = dtype
        self.net = InceptionV3(num_classes=num_classes)
        if weights_path is not None and str(weights_path).endswith((".pth", ".pt")):
            self.net.load_torch_state_dict(load_torch(weights_path))
        elif weights_path is not None:
            self.net.load_flat(load_params(weights_path))
        else:
            rank_zero_warn(
                "InceptionV3FeatureExtractor built without `weights_path`: the network is"
                " randomly initialized, so FID/IS/KID values are NOT comparable to published"
                " numbers. Load pretrained weights (see docs/pretrained_weights.md)."
            )

    def forward(self, imgs: Tensor) -> Tensor:
        byte_images = imgs.dtype == torch.uint8
        if byte_images:
            imgs = imgs.to(torch.float32)
        if not _is_nchw(imgs):
            imgs = imgs.permute(0, 3, 1, 2)
        telemetry.tick("extract:images", imgs.shape[0])
        if self.resize is not None and tuple(imgs.shape[2:]) != (self.resize, self.resize):
            imgs = resize_bilinear_tf1(imgs, self.resize)
            telemetry.tick("extract:resized", imgs.shape[0])
        if byte_images:
            imgs = imgs / 127.5 - 1.0
        imgs = imgs.to(self.dtype)
        out_dt = torch.promote_types(self.dtype, torch.float32)
        marks.mark("extract")  # a captured program's phase mark: the trunk
        with _full_float32():
            if isinstance(self.output, int):
                return self.net(imgs, tap=self.output).mean(dim=(2, 3)).to(out_dt)
            features, logits = self.net(imgs)
        if self.output == "pool":
            return features
        if self.output == "logits_unbiased":
            return logits - self.net.fc.bias.to(logits.dtype)
        return logits


def resolve_ctor_extractor(
    explicit: Any, feature: Any, weights_path: Optional[str], default_output: Any, allowed: Optional[tuple] = None
) -> Any:
    """The metrics' ``feature=`` / ``weights_path=`` sugar: the bundled
    extractor at that output, or ``explicit`` where neither is given; both
    together raise."""
    if feature is None and weights_path is None:
        return explicit
    if explicit is not None:
        raise ValueError(
            "Pass either an explicit extractor callable or the bundled-network"
            " arguments (`feature=` / `weights_path=`), not both"
        )
    if isinstance(feature, np.integer):
        feature = int(feature)
    if isinstance(feature, (float, np.floating)) and float(feature).is_integer():
        feature = int(feature)
    if feature is not None and allowed is not None and feature not in allowed:
        raise ValueError(
            f"Argument `feature` must be one of {allowed}, but got {feature!r}."
            " Inject a `feature_extractor` callable for taps outside the reference's set."
        )
    return InceptionV3FeatureExtractor(weights_path=weights_path, output=default_output if feature is None else feature)


def convert_torch_state_dict(state: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """``torch_fidelity``'s (or torchvision's) InceptionV3 state dict as the
    JAX package's flat tree, byte for byte what
    ``tools/convert_inception_weights.py`` makes of it.

    ``num_batches_tracked`` and ``AuxLogits.*`` are dropped; every other key
    and shape is checked against :class:`InceptionV3` with the head's width
    (an abort names every missing, unexpected and misshapen entry). A 1,000-
    logit head is torchvision's: its features then differ from the FID
    network's, whose pools this network applies, and a warning says so.
    """
    fc = state.get("fc.weight")
    num_classes = int(fc.shape[0]) if fc is not None else 1008
    flat = InceptionV3(num_classes=num_classes).torch_to_flat(state)
    if num_classes != 1008:
        rank_zero_warn(
            f"{num_classes} logits suggests torchvision weights (the FID network has 1008). This network applies"
            " the FID network's pools (branch average pools that leave padding out of the count, a max pool in"
            " Mixed_7c), so its features differ slightly from the torchvision model's. For published-comparable"
            " FID/KID/IS, convert torch_fidelity's pt_inception state dict instead."
        )
    return flat
