"""Plain reference of FID through torch-fidelity's FID InceptionV3, and its control one precision down.

Plain PyTorch, on whatever device the images live; it imports nothing of the program under test.

* The network: torch-fidelity's ``FeatureExtractorInceptionV3`` (``feature_extractor_inceptionv3.py``,
  the network of Szegedy et al., arXiv:1512.00567), written here from its own layer table
  (:data:`CONVS`) with its parameter names, so that :func:`seeded_state_dict` is a ``.pth`` that
  torch-fidelity's module, and the program, load. Each convolution has no bias and is followed by an
  eval-mode batch norm (eps 1e-3) and a ReLU. The FID variant's pools: the branch average pools of
  blocks A, C and E leave the padding out of the count, and Mixed_7c's pool branch is a 3 x 3 max pool.
  The 2048-d features are the mean over the last map; the 1,008-way head is loaded and not run.
* The weights (:func:`seeded_state_dict`): no published file is read. Convolutions He-normal (variance
  2 / fan-in, so that activations keep their scale through the ReLUs); each batch norm's running mean
  and variance, scale and shift drawn near the identity; the head lecun-normal with a zero bias.
* The input (:func:`prepare`): uint8 images to float32 in [0, 255], resized to 299 x 299 by TF1's
  ``resize_bilinear`` (``align_corners=False``, no half-pixel centres: output pixel ``i`` reads the
  input at ``i * in / out``, the last pixel repeated past the edge), then ``x / 127.5 - 1``. That
  normalisation is the program's stated rule; torch-fidelity takes ``(x - 128) / 128``, which this
  reference departs from.
* FID (Heusel et al., arXiv:1706.08500) from float32 features in float64: the means, the unbiased
  covariances, and ``tr(sqrtm(S1 S2))`` as the sum of the square roots of the eigenvalues
  (``eigvalsh``) of ``sqrt(S1) S2 sqrt(S1)``, ``sqrt(S1)`` from ``S1``'s own eigendecomposition.

The forward runs with TF32 off for convolutions and products (``float32``, the configuration's
precision). The control is one precision down: the same forward with TF32 on (``tf32``), and a
``bfloat16`` variant (convolutions on bfloat16 inputs and weights, batch norm in float32). ``float64``
runs every step in float64, for the CPU tests.
"""
import contextlib
import math
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

SIZE = 299
FEATURES = 2048
HEAD = 1008
PRECISIONS = ("float32", "tf32", "bfloat16", "float64")
CONTROL = "tf32"
BN_EPS = 1e-3


def _conv(name: str, cin: int, cout: int, kernel, stride: int = 1, padding=0) -> Tuple:
    kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
    ph, pw = (padding, padding) if isinstance(padding, int) else padding
    return name, cin, cout, (kh, kw), stride, (ph, pw)


def _block_a(name: str, cin: int, pool: int) -> List[Tuple]:
    return [_conv(f"{name}.branch1x1", cin, 64, 1), _conv(f"{name}.branch5x5_1", cin, 48, 1),
            _conv(f"{name}.branch5x5_2", 48, 64, 5, padding=2), _conv(f"{name}.branch3x3dbl_1", cin, 64, 1),
            _conv(f"{name}.branch3x3dbl_2", 64, 96, 3, padding=1),
            _conv(f"{name}.branch3x3dbl_3", 96, 96, 3, padding=1), _conv(f"{name}.branch_pool", cin, pool, 1)]


def _block_c(name: str, c7: int) -> List[Tuple]:
    return [_conv(f"{name}.branch1x1", 768, 192, 1), _conv(f"{name}.branch7x7_1", 768, c7, 1),
            _conv(f"{name}.branch7x7_2", c7, c7, (1, 7), padding=(0, 3)),
            _conv(f"{name}.branch7x7_3", c7, 192, (7, 1), padding=(3, 0)), _conv(f"{name}.branch7x7dbl_1", 768, c7, 1),
            _conv(f"{name}.branch7x7dbl_2", c7, c7, (7, 1), padding=(3, 0)),
            _conv(f"{name}.branch7x7dbl_3", c7, c7, (1, 7), padding=(0, 3)),
            _conv(f"{name}.branch7x7dbl_4", c7, c7, (7, 1), padding=(3, 0)),
            _conv(f"{name}.branch7x7dbl_5", c7, 192, (1, 7), padding=(0, 3)), _conv(f"{name}.branch_pool", 768, 192, 1)]


def _block_e(name: str, cin: int) -> List[Tuple]:
    return [_conv(f"{name}.branch1x1", cin, 320, 1), _conv(f"{name}.branch3x3_1", cin, 384, 1),
            _conv(f"{name}.branch3x3_2a", 384, 384, (1, 3), padding=(0, 1)),
            _conv(f"{name}.branch3x3_2b", 384, 384, (3, 1), padding=(1, 0)),
            _conv(f"{name}.branch3x3dbl_1", cin, 448, 1), _conv(f"{name}.branch3x3dbl_2", 448, 384, 3, padding=1),
            _conv(f"{name}.branch3x3dbl_3a", 384, 384, (1, 3), padding=(0, 1)),
            _conv(f"{name}.branch3x3dbl_3b", 384, 384, (3, 1), padding=(1, 0)),
            _conv(f"{name}.branch_pool", cin, 192, 1)]


# every convolution of the network: (name, in channels, out channels, (kh, kw), stride, (ph, pw))
CONVS: List[Tuple] = [
    _conv("Conv2d_1a_3x3", 3, 32, 3, stride=2), _conv("Conv2d_2a_3x3", 32, 32, 3),
    _conv("Conv2d_2b_3x3", 32, 64, 3, padding=1), _conv("Conv2d_3b_1x1", 64, 80, 1), _conv("Conv2d_4a_3x3", 80, 192, 3),
    *_block_a("Mixed_5b", 192, 32), *_block_a("Mixed_5c", 256, 64), *_block_a("Mixed_5d", 288, 64),
    _conv("Mixed_6a.branch3x3", 288, 384, 3, stride=2), _conv("Mixed_6a.branch3x3dbl_1", 288, 64, 1),
    _conv("Mixed_6a.branch3x3dbl_2", 64, 96, 3, padding=1), _conv("Mixed_6a.branch3x3dbl_3", 96, 96, 3, stride=2),
    *_block_c("Mixed_6b", 128), *_block_c("Mixed_6c", 160), *_block_c("Mixed_6d", 160), *_block_c("Mixed_6e", 192),
    _conv("Mixed_7a.branch3x3_1", 768, 192, 1), _conv("Mixed_7a.branch3x3_2", 192, 320, 3, stride=2),
    _conv("Mixed_7a.branch7x7x3_1", 768, 192, 1), _conv("Mixed_7a.branch7x7x3_2", 192, 192, (1, 7), padding=(0, 3)),
    _conv("Mixed_7a.branch7x7x3_3", 192, 192, (7, 1), padding=(3, 0)),
    _conv("Mixed_7a.branch7x7x3_4", 192, 192, 3, stride=2),
    *_block_e("Mixed_7b", 1280), *_block_e("Mixed_7c", 2048),
]
TABLE = {row[0]: row for row in CONVS}


# ------------------------------------------------------------------ weights
def seeded_state_dict(seed: int) -> Dict[str, Tensor]:
    """torch-fidelity's state dict (``<conv>.conv.weight``, ``<conv>.bn.{weight,bias,running_mean,
    running_var}``, ``fc.weight``, ``fc.bias``), float32 on the CPU, drawn in table order from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    state: Dict[str, Tensor] = {}
    for name, cin, cout, (kh, kw), _, _ in CONVS:
        fan_in = cin * kh * kw
        state[f"{name}.conv.weight"] = torch.randn(cout, cin, kh, kw, generator=g) * math.sqrt(2.0 / fan_in)
        state[f"{name}.bn.weight"] = 1.0 + 0.1 * (torch.rand(cout, generator=g) - 0.5)
        state[f"{name}.bn.bias"] = 0.05 * torch.randn(cout, generator=g)
        state[f"{name}.bn.running_mean"] = 0.05 * torch.randn(cout, generator=g)
        state[f"{name}.bn.running_var"] = 1.0 + 0.2 * (torch.rand(cout, generator=g) - 0.5)
    state["fc.weight"] = torch.randn(HEAD, FEATURES, generator=g) / math.sqrt(FEATURES)
    state["fc.bias"] = torch.zeros(HEAD)
    return state


# ------------------------------------------------------------------ input
def resize_tf1(x: Tensor, size: int) -> Tensor:
    """TF1 ``resize_bilinear`` of float ``(N, C, H, W)`` to ``size x size``, as torch-fidelity's
    ``interpolate_bilinear_2d_like_tensorflow1x`` writes it: four corner gathers, across the width and
    then the height, the source position ``i * (in / out)`` in float32."""
    def grid(n_in: int) -> Tuple[Tensor, Tensor, Tensor]:
        pos = torch.arange(size, dtype=torch.float32, device=x.device) * torch.tensor(n_in / size, dtype=torch.float32)
        lo = pos.long()
        return lo, (lo + 1).clamp_max(n_in - 1), (pos - lo.float()).to(x.dtype)

    y_lo, y_hi, dy = grid(x.shape[2])
    x_lo, x_hi, dx = grid(x.shape[3])
    rows_lo, rows_hi = x[:, :, y_lo, :], x[:, :, y_hi, :]
    top = rows_lo[:, :, :, x_lo] + (rows_lo[:, :, :, x_hi] - rows_lo[:, :, :, x_lo]) * dx.view(1, 1, 1, size)
    bottom = rows_hi[:, :, :, x_lo] + (rows_hi[:, :, :, x_hi] - rows_hi[:, :, :, x_lo]) * dx.view(1, 1, 1, size)
    return top + (bottom - top) * dy.view(1, 1, size, 1)


def prepare(images: Tensor, size: int = SIZE) -> Tensor:
    """uint8 ``(N, 3, H, W)`` in [0, 255] -> float32 at ``size x size`` in [-1, 1]."""
    x = images.to(torch.float32)
    if tuple(x.shape[2:]) != (size, size):
        x = resize_tf1(x, size)
    return x / 127.5 - 1.0


# ------------------------------------------------------------------ network
@contextlib.contextmanager
def tf32(on: bool) -> Iterator[None]:
    """TF32 for cuDNN convolutions and cuBLAS products on (the control) or off, restored after."""
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


class Network:
    """The forward of :data:`CONVS` over a state dict on ``device``, in one precision of :data:`PRECISIONS`.
    ``record`` (optional) is told each convolution's name, input and output shapes."""

    def __init__(self, state: Dict[str, Tensor], device: torch.device, precision: str = "float32",
                 record=None) -> None:
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.precision, self.record = precision, record
        self.dtype = torch.float64 if precision == "float64" else torch.float32  # batch norm and features
        conv_dt = torch.bfloat16 if precision == "bfloat16" else self.dtype
        self.w = {k: v.to(device, conv_dt if k.endswith("conv.weight") else self.dtype) for k, v in state.items()}

    def conv(self, name: str, x: Tensor) -> Tensor:
        _, _, _, _, stride, padding = TABLE[name]
        weight = self.w[f"{name}.conv.weight"]
        y = F.conv2d(x.to(weight.dtype), weight, None, stride, padding).to(self.dtype)
        if self.record is not None:
            self.record(name, tuple(x.shape), tuple(y.shape))
        w = self.w
        y = F.batch_norm(y, w[f"{name}.bn.running_mean"], w[f"{name}.bn.running_var"], w[f"{name}.bn.weight"],
                         w[f"{name}.bn.bias"], False, 0.0, BN_EPS)
        return F.relu(y)

    def chain(self, x: Tensor, *names: str) -> Tensor:
        for name in names:
            x = self.conv(name, x)
        return x

    def block_a(self, n: str, x: Tensor) -> Tensor:
        pool = F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)
        return torch.cat([self.conv(f"{n}.branch1x1", x), self.chain(x, f"{n}.branch5x5_1", f"{n}.branch5x5_2"),
                          self.chain(x, f"{n}.branch3x3dbl_1", f"{n}.branch3x3dbl_2", f"{n}.branch3x3dbl_3"),
                          self.conv(f"{n}.branch_pool", pool)], 1)

    def block_b(self, n: str, x: Tensor) -> Tensor:
        return torch.cat([self.conv(f"{n}.branch3x3", x),
                          self.chain(x, f"{n}.branch3x3dbl_1", f"{n}.branch3x3dbl_2", f"{n}.branch3x3dbl_3"),
                          F.max_pool2d(x, 3, 2)], 1)

    def block_c(self, n: str, x: Tensor) -> Tensor:
        pool = F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)
        return torch.cat([self.conv(f"{n}.branch1x1", x),
                          self.chain(x, f"{n}.branch7x7_1", f"{n}.branch7x7_2", f"{n}.branch7x7_3"),
                          self.chain(x, *(f"{n}.branch7x7dbl_{i}" for i in range(1, 6))),
                          self.conv(f"{n}.branch_pool", pool)], 1)

    def block_d(self, n: str, x: Tensor) -> Tensor:
        return torch.cat([self.chain(x, f"{n}.branch3x3_1", f"{n}.branch3x3_2"),
                          self.chain(x, *(f"{n}.branch7x7x3_{i}" for i in range(1, 5))), F.max_pool2d(x, 3, 2)], 1)

    def block_e(self, n: str, x: Tensor, pool: str) -> Tensor:
        b3 = self.conv(f"{n}.branch3x3_1", x)
        bd = self.chain(x, f"{n}.branch3x3dbl_1", f"{n}.branch3x3dbl_2")
        pooled = F.max_pool2d(x, 3, 1, 1) if pool == "max" else F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)
        return torch.cat([self.conv(f"{n}.branch1x1", x),
                          self.conv(f"{n}.branch3x3_2a", b3), self.conv(f"{n}.branch3x3_2b", b3),
                          self.conv(f"{n}.branch3x3dbl_3a", bd), self.conv(f"{n}.branch3x3dbl_3b", bd),
                          self.conv(f"{n}.branch_pool", pooled)], 1)

    def features(self, x: Tensor) -> Tensor:
        """``(N, 3, 299, 299)`` in [-1, 1] -> ``(N, 2048)``, float32 (float64 in ``float64``)."""
        with tf32(self.precision == "tf32"):
            x = self.chain(x.to(self.dtype), "Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3")
            x = self.chain(F.max_pool2d(x, 3, 2), "Conv2d_3b_1x1", "Conv2d_4a_3x3")
            x = F.max_pool2d(x, 3, 2)
            for n in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
                x = self.block_a(n, x)
            x = self.block_b("Mixed_6a", x)
            for n in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
                x = self.block_c(n, x)
            x = self.block_d("Mixed_7a", x)
            x = self.block_e("Mixed_7c", self.block_e("Mixed_7b", x, "avg"), "max")
            return x.mean(dim=(2, 3))


def features(state: Dict[str, Tensor], batches: Iterable[Tensor], precision: str = "float32",
             chunk: Optional[int] = None, size: int = SIZE) -> Tensor:
    """Float32 ``(N, 2048)`` features of uint8 image batches resized to ``size``, in order; each batch
    in ``chunk``s."""
    out, net = [], None
    with torch.no_grad():
        for batch in batches:
            net = net or Network(state, batch.device, precision)
            step = chunk or batch.shape[0]
            for i in range(0, batch.shape[0], step):
                out.append(net.features(prepare(batch[i:i + step], size)))
    return torch.cat(out)


def conv_shapes(size: int = SIZE) -> List[Tuple[str, Tuple[int, ...], Tuple[int, ...]]]:
    """Each convolution's ``(name, input shape, output shape)`` for one ``size x size`` image, in call
    order, from a forward on the ``meta`` device (no data, no weights)."""
    meta = torch.device("meta")
    state = {}
    for name, cin, cout, kernel, _, _ in CONVS:
        state[f"{name}.conv.weight"] = torch.empty(cout, cin, *kernel, device=meta)
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            state[f"{name}.bn.{leaf}"] = torch.empty(cout, device=meta)
    seen: List[Tuple[str, Tuple[int, ...], Tuple[int, ...]]] = []
    Network(state, meta, record=lambda *row: seen.append(row)).features(torch.empty(1, 3, size, size, device=meta))
    return seen


# ------------------------------------------------------------------ FID
def mean_cov(feats: Tensor) -> Tuple[Tensor, Tensor]:
    """Float64 mean and unbiased covariance of ``(N, D)`` features."""
    x = feats.to(torch.float64)
    mu = x.mean(0)
    xc = x - mu
    return mu, xc.T @ xc / (x.shape[0] - 1)


def _psd_sqrt(mat: Tensor) -> Tensor:
    vals, vecs = torch.linalg.eigh((mat + mat.T) / 2)
    return (vecs * vals.clamp_min(0).sqrt()) @ vecs.T


def fid(mu1: Tensor, sigma1: Tensor, mu2: Tensor, sigma2: Tensor) -> float:
    """FID of two float64 Gaussians."""
    with tf32(False):
        root = _psd_sqrt(sigma1)
        inner = root @ sigma2 @ root
        trace_sqrt = torch.linalg.eigvalsh((inner + inner.T) / 2).clamp_min(0).sqrt().sum()
        diff = mu1 - mu2
        return float(diff @ diff + torch.trace(sigma1) + torch.trace(sigma2) - 2 * trace_sqrt)


def effective_rank(sigma: Tensor) -> float:
    """``exp`` of the entropy of a covariance's normalised eigenvalues: how many directions the features spread in."""
    vals = torch.linalg.eigvalsh(sigma.to(torch.float64)).clamp_min(0)
    p = vals / vals.sum()
    p = p[p > 0]
    return float(torch.exp(-(p * p.log()).sum()))
