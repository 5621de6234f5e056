"""Spectral distortion index (D-lambda): port of ``metrics_tpu/functional/image/d_lambda.py``.

Both images' band-by-band UQI matrices are built from every band pair
``k <= r`` (``L(L + 1) / 2`` pairs), the pairs' single-band images stacked
along the batch of one UQI call, as in the JAX package. Past
:data:`PAIR_CHUNK_BYTES` of padded planes in a stack the pairs go through in
chunks (200 bands of 145 x 145 are 20,100 pairs, 1.9 GB a stack): a pair's
value does not depend on the others in its call. A call's peak memory is
about 23 times its stack of planes (the five statistics in and out, their
products and the map's temporaries), so a chunk peaks near 6 GB. One indexed write over
``torch.triu_indices`` fills both triangles.
"""
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.image.uqi import _uqi_compute
from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.data import dtype_name
from metrics_tpu_torch.utilities.distributed import reduce

PAIR_CHUNK_BYTES = 1 << 28
_UQI_PAD = 5  # the default 11 x 11 window's pad a side


def _spectral_distortion_index_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Check dtypes and shapes: ``(B, C, H, W)``."""
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {dtype_name(preds.dtype)} and target: {dtype_name(target.dtype)}."
        )
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    return preds, target


def pair_chunk(x: Tensor) -> int:
    """How many band pairs of ``x`` (B, L, H, W) one UQI call takes: the
    padded single-band planes of a chunk stay within :data:`PAIR_CHUNK_BYTES`."""
    b, _, h, w = x.shape
    plane = b * (h + 2 * _UQI_PAD) * (w + 2 * _UQI_PAD) * x.element_size()
    return max(1, PAIR_CHUNK_BYTES // plane)


def _pairwise_band_uqi(x: Tensor) -> Tensor:
    """The ``L x L`` matrix of UQI between every pair of bands of ``x`` (B, L, H, W)."""
    b, length, h, w = x.shape
    rows, cols = torch.triu_indices(length, length, device=x.device)
    step = pair_chunk(x)
    per_pair = []
    for start in range(0, rows.numel(), step):
        k, r = rows[start:start + step], cols[start:start + step]
        # pair-major, then batch: (P * B, 1, H, W), each pair's block of B images together
        a = x[:, k].transpose(0, 1).reshape(-1, 1, h, w)
        bands = x[:, r].transpose(0, 1).reshape(-1, 1, h, w)
        uqi_map = _uqi_compute(a, bands, reduction="none")
        per_pair.append(uqi_map.reshape(k.numel(), -1).mean(dim=1))
    values = torch.cat(per_pair)
    m = torch.zeros((length, length), dtype=values.dtype, device=x.device)
    m[torch.cat((rows, cols)), torch.cat((cols, rows))] = torch.cat((values, values))
    return m


def _spectral_distortion_index_compute(
    preds: Tensor,
    target: Tensor,
    p: int = 1,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    length = preds.shape[1]
    m1 = _pairwise_band_uqi(target)
    m2 = _pairwise_band_uqi(preds)

    diff = torch.abs(m1 - m2) ** p
    if length == 1:
        output = diff ** (1.0 / p)
    else:
        output = (1.0 / (length * (length - 1)) * torch.sum(diff)) ** (1.0 / p)
    return reduce(output, reduction)


def spectral_distortion_index(
    preds: Tensor,
    target: Tensor,
    p: int = 1,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """D-lambda between two multispectral images: how far the bands' UQI
    relations of ``preds`` are from ``target``'s.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import spectral_distortion_index
        >>> preds = torch.rand(2, 3, 16, 16, generator=torch.manual_seed(42))
        >>> round(float(spectral_distortion_index(preds, preds * 0.9)), 4)
        0.0
    """
    if not isinstance(p, int) or p <= 0:
        raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
    preds, target = _spectral_distortion_index_update(preds, target)
    return _spectral_distortion_index_compute(preds, target, p, reduction)
