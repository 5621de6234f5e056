"""The quantised wire of the sync buckets: port of ``metrics_tpu/quant.py``.

A pure codec, plain tensor ops on whatever device the bucket lives on, with
a numpy twin for host-side buffers. It gives the JAX package's bits: the same
codes, scales and packed planes for the same input.

Wire formats
============

``q8``: block-wise symmetric int8. The flat buffer is cut into blocks of
``block`` elements (256 for float32 and anything unspecified, 128 for
float64; ``METRICS_TPU_QUANT_BLOCK`` overrides both); each block crosses as
int8 codes and one float32 scale, ``amax / 127``, so that zero stays zero.
Wire cost ``1 + 4 / block`` bytes an element: 3.94x less than float32 at the
default block.

``pack<bits>``: bit-plane packing of small non-negative integers, ``bits``
planes of 8 values a byte, exact for ``0 <= v < 2**bits``: the HyperLogLog
registers (5 bits at the default precision, 6.4x less than int32).

Error model
===========

* Accumulation is always at full precision: encode, one collective on the
  payload, decode, then reduce in the state's dtype.
* Float states (``q8``, nearest): ``|decoded - x| <= amax_block / 254`` an
  element; zero blocks are exact.
* Integer sums: decoded values are rounded back to integers, exact while
  every block's largest magnitude is at most ``INT_EXACT_BOUND`` (127).
* Never-underestimate states (``rounding="up"``, count-min): codes are
  ``ceil`` over a denominator of 126, so ``x <= decoded <= x + amax_block / 126``.
* Registers (``pack``): lossless.

Kill switch: ``METRICS_TPU_QUANT_SYNC=0`` turns every quantised path off.
Both rounding rules round as the JAX package does: ``torch.round`` and
``jnp.rint`` both round half to even.
"""
import os
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

DEFAULT_BLOCK = 256
# float64 halves the block: 4 bytes of scale over 128 code bytes cost ~1.6% of the wire and halve every
# block's amax radius
DEFAULT_BLOCK_F64 = 128
# integer leaves are exact through the q8 wire while every block's largest magnitude is at most this
INT_EXACT_BOUND = 127
# the nearest-rounded q8 wire's error an element, as a fraction of its block's largest magnitude
REL_ERROR_BOUND = 1.0 / 254.0


def quant_enabled() -> bool:
    """Whether the quantised wire is on (default yes; a metric still opts
    in with ``sync_precision=``). ``METRICS_TPU_QUANT_SYNC=0`` (or
    ``false``/``off``) turns it off."""
    return os.environ.get("METRICS_TPU_QUANT_SYNC", "1").strip().lower() not in ("0", "false", "off")


def default_block(dtype: Optional[Any] = None) -> int:
    """The q8 block: ``METRICS_TPU_QUANT_BLOCK`` (at least 8) where set, else
    128 for float64 and 256 otherwise. Both ends of the wire derive it from
    the same dtype and setting, so their layouts agree."""
    raw = os.environ.get("METRICS_TPU_QUANT_BLOCK")
    if raw is not None:
        try:
            return max(8, int(raw))
        except ValueError:
            pass
    if dtype is torch.float64 or (dtype is not None and not isinstance(dtype, torch.dtype) and np.dtype(dtype) == np.float64):
        return DEFAULT_BLOCK_F64
    return DEFAULT_BLOCK


class QuantCodec(NamedTuple):
    """One leaf's wire encoding: ``kind`` ``"q8"`` (block int8 and float32
    scales) or ``"pack"`` (bit planes, ``bits`` wide); ``rounding``
    ``"nearest"`` or ``"up"`` (ceil codes, for never-underestimate sketches)."""

    kind: str
    bits: int = 8
    rounding: str = "nearest"


def wire_tag(codec: Optional[QuantCodec], wire_name: str) -> str:
    """A bucket key's wire label: the dtype's name at full precision, else
    ``q8:<dtype>``, ``q8u:<dtype>`` or ``pack<bits>:<dtype>``; codecs of
    different semantics never share a bucket."""
    if codec is None:
        return wire_name
    if codec.kind == "pack":
        return f"pack{codec.bits}:{wire_name}"
    return f"q8{'u' if codec.rounding == 'up' else ''}:{wire_name}"


def bits_for_bound(bound: int) -> int:
    """The fewest bits that hold ``0..bound`` (at least 1)."""
    return max(1, int(bound).bit_length())


# ------------------------------------------------------------ tensor codec
def encode_q8(x: Tensor, block: Optional[int] = None, rounding: str = "nearest") -> Tuple[Tensor, Tensor]:
    """Block-wise symmetric int8: ``(codes (nblocks, block) int8, scales
    (nblocks,) float32)``; the padding past the end encodes as zero."""
    block = block or default_block()
    x = x.reshape(-1).to(torch.float32)
    n = x.numel()
    nb = -(-n // block)
    if nb * block != n:
        x = torch.nn.functional.pad(x, (0, nb * block - n))
    xb = x.reshape(nb, block)
    amax = xb.abs().amax(dim=1)
    denom = 126.0 if rounding == "up" else 127.0
    scale = torch.where(amax > 0, amax / denom, torch.ones_like(amax))
    y = xb / scale[:, None]
    q = torch.ceil(y) if rounding == "up" else torch.round(y)
    return q.clamp(-127.0, 127.0).to(torch.int8), scale


def decode_q8(q: Tensor, scale: Tensor, n: int) -> Tensor:
    """:func:`encode_q8`'s output back to a flat float32 ``(n,)``."""
    return (q.to(torch.float32) * scale[:, None]).reshape(-1)[:n]


def pack_bits(x: Tensor, bits: int) -> Tensor:
    """Bit-plane pack non-negative integers below ``2**bits`` into uint8:
    plane ``j`` holds bit ``j`` of 8 consecutive values a byte. Exact."""
    x = x.reshape(-1).to(torch.int64)
    n = x.numel()
    g = -(-n // 8)
    if g * 8 != n:
        x = torch.nn.functional.pad(x, (0, g * 8 - n))
    xb = x.reshape(g, 8)
    weights = torch.ones(8, dtype=torch.int64, device=x.device) << torch.arange(8, device=x.device)
    planes = [(((xb >> j) & 1) * weights).sum(dim=1).to(torch.uint8) for j in range(bits)]
    return planes[0] if bits == 1 else torch.cat(planes)


def unpack_bits(packed: Tensor, bits: int, n: int) -> Tensor:
    """:func:`pack_bits` undone; int32 ``(n,)``."""
    g = -(-n // 8)
    planes = packed.reshape(bits, g).to(torch.int64)
    lanes = torch.arange(8, device=packed.device)
    vals = torch.zeros((g, 8), dtype=torch.int64, device=packed.device)
    for j in range(bits):
        vals = vals | (((planes[j][:, None] >> lanes) & 1) << j)
    return vals.reshape(-1)[:n].to(torch.int32)


def bucket_wire_nbytes(n: int, codec: QuantCodec, block: Optional[int] = None) -> int:
    """Bytes of one encoded bucket of ``n`` elements."""
    if codec.kind == "pack":
        return codec.bits * (-(-n // 8))
    block = block or default_block()
    nb = -(-n // block)
    return nb * block + 4 * nb


def encode_bucket(buf: Tensor, codec: QuantCodec, block: Optional[int] = None) -> Tensor:
    """A flat bucket as the one uint8 payload its collective carries: the
    codes, then the scales' bytes (little-endian float32), so the payload's
    size depends on ``n`` alone."""
    if codec.kind == "pack":
        return pack_bits(buf, codec.bits)
    q, scale = encode_q8(buf, block=block, rounding=codec.rounding)
    return torch.cat([q.reshape(-1).view(torch.uint8), scale.view(torch.uint8)])


def decode_bucket(payload: Tensor, codec: QuantCodec, n: int, block: Optional[int] = None) -> Tensor:
    """One :func:`encode_bucket` payload back to a flat buffer: float32
    ``(n,)`` for ``q8``, int32 ``(n,)`` for ``pack``."""
    if codec.kind == "pack":
        return unpack_bits(payload, codec.bits, n)
    block = block or default_block()
    nb = -(-n // block)
    payload = payload.contiguous()
    q = payload[: nb * block].view(torch.int8).reshape(nb, block)
    scale = payload[nb * block : nb * block + 4 * nb].clone().view(torch.float32)
    return decode_q8(q, scale, n)


# ------------------------------------------------------------- numpy twin
def np_encode_q8(x: np.ndarray, block: Optional[int] = None, rounding: str = "nearest") -> Tuple[bytes, bytes]:
    """:func:`encode_q8` on the host: ``(code bytes, scale bytes)``."""
    block = block or default_block()
    x = np.asarray(x, dtype=np.float32).ravel()
    n = x.size
    nb = -(-n // block)
    if nb * block != n:
        x = np.pad(x, (0, nb * block - n))
    xb = x.reshape(nb, block)
    amax = np.max(np.abs(xb), axis=1)
    denom = 126.0 if rounding == "up" else 127.0
    scale = np.where(amax > 0, amax / np.float32(denom), np.float32(1.0)).astype(np.float32)
    y = xb / scale[:, None]
    q = np.ceil(y) if rounding == "up" else np.rint(y)
    q = np.clip(q, -127.0, 127.0).astype(np.int8)
    return q.tobytes(), scale.tobytes()


def np_decode_q8(q_bytes: bytes, scale_bytes: bytes, n: int, block: Optional[int] = None) -> np.ndarray:
    """:func:`decode_q8` on the host, from the wire's bytes."""
    block = block or default_block()
    nb = -(-n // block)
    q = np.frombuffer(q_bytes, dtype=np.int8).reshape(nb, block)
    scale = np.frombuffer(scale_bytes, dtype=np.float32)
    return (q.astype(np.float32) * scale[:, None]).reshape(-1)[:n]
