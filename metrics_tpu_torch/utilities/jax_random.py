"""The few ``jax.random`` draws the image metrics take, bit for bit, in torch.

``jax.random`` with its default implementation (threefry2x32) and
``jax_threefry_partitionable`` on, as jax 0.9 runs it with x64 off: a key is
raw key data, two uint32 words; :func:`PRNGKey` makes one from an int seed,
:func:`split` and :func:`fold_in` derive keys, :func:`uniform` and
:func:`randint` draw from one. KID's ``compute_rng_key`` and IS's
``assignment_rng_key`` decide which subset or split a sample falls in, so the
port draws exactly what the JAX package draws for the same key.

torch's ``uint32`` lacks most arithmetic, so a 32-bit word is held in an
int64 tensor in ``[0, 2**32)``, masked after every add and multiply; a key is
an int64 tensor of shape ``(2,)``. Every function runs on the key's device
with tensor operations only (no host read), so a draw keyed by a device count
(IS's ``fold_in`` on the samples seen) can be captured in a CUDA graph.
"""
from typing import Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: Tensor, d: int) -> Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def _mul32(a: Tensor, b: int) -> Tensor:
    """``a * b`` modulo 2**32 of two words, in two 16-bit halves of ``b`` so
    that no product leaves int64."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & MASK


def threefry2x32(k1: Tensor, k2: Tensor, x1: Tensor, x2: Tensor) -> Tuple[Tensor, Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the word pairs ``(x1, x2)``
    under the key ``(k1, k2)``, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1, x2 = (x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def PRNGKey(seed: int, device: Union[str, torch.device, None] = None) -> Tensor:  # noqa: N802 -- jax's name
    """``jax.random.PRNGKey(seed)`` with x64 off: the seed wraps to int32, so
    the key is ``(0, seed mod 2**32)``; a seed past int64 raises as there."""
    seed = int(np.int64(seed))  # OverflowError past int64, as jax's np.int64(seed)
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def as_key_data(key: Union[Tensor, np.ndarray]) -> Tensor:
    """A raw uint32 ``(..., 2)`` key (numpy or torch) as the int64 words
    this module computes on, on the key's device."""
    if isinstance(key, np.ndarray):
        return torch.from_numpy(key.astype(np.int64))
    return key.to(torch.int64) & MASK


def _iota(shape: Sequence[int], device: torch.device) -> Tuple[Tensor, Tensor]:
    """The high and low words of a row-major 64-bit iota of ``shape``."""
    n = int(np.prod(shape, dtype=np.int64)) if len(shape) else 1
    flat = torch.arange(n, dtype=torch.int64, device=device)
    return (flat >> 32).reshape(tuple(shape)), (flat & MASK).reshape(tuple(shape))


def _bits(key: Tensor, shape: Sequence[int]) -> Tensor:
    """``jax.random.bits(key, shape, uint32)`` (partitionable): the two hash
    words of each element's 64-bit index, xor'd."""
    hi, lo = _iota(shape, key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return b1 ^ b2


def split(key: Tensor, num: Union[int, Sequence[int]] = 2) -> Tensor:
    """``jax.random.split(key, num)`` (partitionable): key ``i`` is the hash
    of the index ``i``'s two words; shape ``(*num, 2)``."""
    shape = (num,) if isinstance(num, int) else tuple(num)
    hi, lo = _iota(shape, key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: Tensor, data: Union[int, Tensor]) -> Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the pair ``(0, data)``,
    ``data`` taken as uint32 (a negative int32 wraps), a device tensor or an
    int."""
    if not isinstance(data, Tensor):
        data = torch.tensor(int(data), dtype=torch.int64, device=key.device)
    data = data.to(device=key.device, dtype=torch.int64) & MASK
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(data), data)
    return torch.stack([b1, b2]).reshape(2)


def uniform(key: Tensor, shape: Sequence[int] = ()) -> Tensor:
    """``jax.random.uniform(key, shape)`` in float32 on ``[0, 1)``: the top
    23 bits as the mantissa of a float in ``[1, 2)``, less 1."""
    bits = _bits(key, tuple(shape))
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats, 0.0)


def randint(key: Tensor, shape: Sequence[int], minval: int, maxval: int) -> Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` in int32: two
    words a value from the two halves of ``split(key)``, folded into the
    span by jax's modulus rule."""
    if not -(2**31) <= min(minval, maxval) <= max(minval, maxval) <= 2**31 - 1:
        raise ValueError(f"randint's bounds must be int32, got [{minval}, {maxval})")
    k1, k2 = split(key)
    higher, lower = _bits(k1, tuple(shape)), _bits(k2, tuple(shape))
    span = maxval - minval if maxval > minval else 1
    multiplier = (2**16) % span
    multiplier = ((multiplier * multiplier) & MASK) % span  # a uint32 product: it wraps
    offset = (_mul32(higher % span, multiplier) + lower % span) & MASK
    return (minval + offset % span).to(torch.int32)
