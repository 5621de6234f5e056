"""Sketch aggregators: sublinear, mergeable, fixed-shape streaming state.

Port of ``metrics_tpu/streaming/sketch.py``:

* :class:`QuantileSketch`: a DDSketch-style log-spaced histogram
  (``dist_reduce_fx="sum"``), any quantile within relative error ``alpha``;
* :class:`HostQuantileSketch`: its numpy-only twin for host-side recording;
* :class:`HyperLogLog`: distinct counts (``dist_reduce_fx="max"``: the
  register-wise max is the union);
* :class:`CountMinHeavyHitters`: a count-min frequency table
  (``dist_reduce_fx="sum"``), never an underestimate; its update is one
  launch of the ``countmin`` kernel on the card.

Values are hashed by their float32 bit pattern with the JAX package's
uint32 finalizer (:func:`metrics_tpu_torch.ops.hash_u32`, exact in int64).
The three device sketches take masked updates (``metrics_tpu/streaming/sketch.py:131,
333, 417``), so the fast-dispatch engine pads their batches into shape
buckets. Each device sketch registers its codec for the quantised sync wire
(``_quant_state_specs``, used where ``sync_precision="int8"``): q8 for the
quantile histogram, lossless bit planes for the HyperLogLog registers, and q8
rounded up for the count-min table, so that it never underestimates. Not
ported yet: the telemetry events (ROADMAP.md, Queue A item 10).
"""
from typing import Any, Optional, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch import quant
from metrics_tpu_torch.aggregation import BaseAggregator
from metrics_tpu_torch.ops.sketch_ops import as_u32_bits, countmin_update, hash_u32

__all__ = [
    "QuantileSketch",
    "HostQuantileSketch",
    "HyperLogLog",
    "CountMinHeavyHitters",
]

_SEED_STEP = 0x9E3779B9


def _key_bits(x: Tensor) -> Tensor:
    """The float32 bit pattern of each value, as int32 (``-0.0`` is made
    ``+0.0`` first, so that equal keys hash equally)."""
    x = torch.where(x == 0.0, 0.0, x)
    return x.to(torch.float32).view(torch.int32)


def _clz32(x: Tensor) -> Tensor:
    """Leading zeros of uint32 values held in int64 (32 for 0), exact: a
    binary search for the bit length in integer arithmetic."""
    length = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        high = x >> shift
        found = high > 0
        length = length + torch.where(found, shift, 0)
        x = torch.where(found, high, x)
    return 32 - (length + (x > 0).to(length.dtype))


class QuantileSketch(BaseAggregator):
    """Streaming quantiles with bounded relative error (DDSketch-style).

    Values land in log-spaced bins with base ``gamma = (1+alpha)/(1-alpha)``;
    the state is one ``(2*bins + 1,)`` float32 count vector (``bins``
    negative buckets, one zero bucket, ``bins`` positive buckets), merged by
    elementwise sum. Keys beyond the extreme bins are clipped into them.

    Args:
        bins: buckets per sign (default 512).
        alpha: target relative accuracy (default 0.01).
        nan_strategy: as :class:`~metrics_tpu_torch.aggregation.BaseAggregator`
            (default ``"warn"``: NaN contributions are masked out).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.streaming import QuantileSketch
        >>> s = QuantileSketch(device="cpu")
        >>> s.update(torch.linspace(1.0, 100.0, 1000))
        >>> bool(abs(float(s.quantile(0.5)) - 50.5) < 1.5)
        True
    """

    full_state_update = False

    def __init__(
        self, bins: int = 512, alpha: float = 0.01, nan_strategy: Union[str, float] = "warn", **kwargs: Any
    ) -> None:
        bins, alpha = int(bins), float(alpha)
        if bins <= 0:
            raise ValueError(f"bins must be positive, got {bins}")
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        super().__init__("sum", torch.zeros((2 * bins + 1,), dtype=torch.float32), nan_strategy, **kwargs)
        # histogram counts are float32 sums whose error budget is loose (the sketch is alpha-approximate)
        self._quant_state_specs = {"value": quant.QuantCodec("q8")}
        self.bins = bins
        self.alpha = alpha
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self.min_key = -(bins // 2)

    def _index(self, x: Tensor) -> Tensor:
        """Bucket index per element (values finite or inf, no NaN), with the
        log taken in float32 as in the JAX package."""
        absx = x.abs()
        safe = torch.where(absx > 0, absx, 1.0)
        log_gamma = torch.log(torch.full((), self.gamma, dtype=torch.float32, device=x.device))
        key = torch.ceil(torch.log(safe) / log_gamma)
        kidx = (key.clamp(self.min_key, self.min_key + self.bins - 1) - self.min_key).to(torch.int64)
        idx_pos = self.bins + 1 + kidx
        idx_neg = (self.bins - 1) - kidx
        return torch.where(x > 0, idx_pos, torch.where(x < 0, idx_neg, self.bins))

    def update(self, value: Union[float, Tensor]) -> None:
        value, mask = self._cast_and_nan_mask_input(value)
        value, mask = torch.atleast_1d(value), torch.atleast_1d(mask)
        idx = self._index(torch.where(mask, value, 1.0))
        self.value = self.value.index_add(0, idx.reshape(-1), mask.to(torch.float32).reshape(-1))

    def _masked_update_supported(self) -> bool:
        return True

    def _masked_update(self, sample_mask: Tensor, value: Union[float, Tensor]) -> None:
        value, mask = self._cast_and_nan_mask_input(value)
        value, mask = torch.atleast_1d(value), torch.atleast_1d(mask)
        mask = mask & torch.broadcast_to(torch.atleast_1d(sample_mask), mask.shape)
        idx = self._index(torch.where(mask, value, 1.0))
        self.value = self.value.index_add(0, idx.reshape(-1), mask.to(torch.float32).reshape(-1))

    def quantile(self, q: Union[float, Tensor]) -> Tensor:
        """Estimate quantile(s) ``q`` in [0, 1] (scalar or vector); NaN when
        the sketch is empty."""
        counts = self.value
        total = counts.sum()
        cum = torch.cumsum(counts, dim=0)
        q = torch.as_tensor(q, dtype=torch.float32, device=counts.device).clamp(0.0, 1.0)
        target = torch.clamp(q * total, min=1.0)
        idx = torch.argmax((cum >= target[..., None]).to(torch.uint8), dim=-1)
        rel = idx - self.bins  # <0 negative bins, 0 zero bucket, >0 positive
        key = torch.where(rel > 0, rel - 1, -rel - 1) + self.min_key
        mag = 2.0 * torch.pow(self.gamma, key.to(torch.float32)) / (self.gamma + 1.0)
        val = torch.where(rel == 0, 0.0, torch.where(rel > 0, mag, -mag))
        return torch.where(total > 0, val, float("nan"))

    def compute(self) -> Tensor:
        """Median estimate; use :meth:`quantile` for other ranks."""
        return self.quantile(0.5)


class HostQuantileSketch:
    """Host-side (numpy-only) twin of :class:`QuantileSketch`.

    The same binning in float32, the same ``(2*bins + 1,)`` layout, so a
    count vector moves between the two (:meth:`to_device`) into identical
    bins; ``add`` is a few scalar operations, ``merge`` an elementwise sum.

    Example:
        >>> from metrics_tpu_torch.streaming import HostQuantileSketch
        >>> s = HostQuantileSketch()
        >>> s.add_many([float(v) for v in range(1, 101)])
        >>> bool(abs(s.quantile(0.5) - 50.0) < 1.0)
        True
    """

    def __init__(self, bins: int = 512, alpha: float = 0.01) -> None:
        bins, alpha = int(bins), float(alpha)
        if bins <= 0:
            raise ValueError(f"bins must be positive, got {bins}")
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        self.bins = bins
        self.alpha = alpha
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self.min_key = -(bins // 2)
        self.counts = np.zeros((2 * bins + 1,), np.float64)

    @property
    def count(self) -> float:
        """Total weight absorbed so far."""
        return float(self.counts.sum())

    @property
    def nbytes(self) -> int:
        return int(self.counts.nbytes)

    def _index(self, x: float) -> int:
        absx = abs(x)
        if absx > 0:
            key = float(np.ceil(np.log(np.float32(absx)) / np.log(np.float32(self.gamma))))
            kidx = int(np.clip(key, self.min_key, self.min_key + self.bins - 1)) - self.min_key
        else:
            kidx = 0
        if x > 0:
            return self.bins + 1 + kidx
        if x < 0:
            return (self.bins - 1) - kidx
        return self.bins

    def add(self, value: float, weight: float = 1.0) -> None:
        """Absorb one observation (NaN is dropped, as the device sketch masks it)."""
        value = float(value)
        if value != value:  # NaN
            return
        self.counts[self._index(value)] += float(weight)

    def add_many(self, values: Any) -> None:
        for v in values:
            self.add(v)

    def merge(self, other: "HostQuantileSketch") -> "HostQuantileSketch":
        """In-place elementwise-sum merge; shapes must match."""
        if (other.bins, round(other.alpha, 12)) != (self.bins, round(self.alpha, 12)):
            raise ValueError(
                f"cannot merge sketches with different shapes: "
                f"(bins={self.bins}, alpha={self.alpha}) vs (bins={other.bins}, alpha={other.alpha})"
            )
        self.counts += other.counts
        return self

    def quantile(self, q: float) -> float:
        """Estimate quantile ``q`` in [0, 1]; NaN on an empty sketch."""
        total = self.counts.sum()
        if total <= 0:
            return float("nan")
        cum = np.cumsum(self.counts)
        target = max(float(q) * total, 1.0)
        idx = int(np.argmax(cum >= target))
        rel = idx - self.bins
        if rel == 0:
            return 0.0
        key = (rel - 1 if rel > 0 else -rel - 1) + self.min_key
        mag = 2.0 * self.gamma**key / (self.gamma + 1.0)
        return mag if rel > 0 else -mag

    def to_device(self, device: Optional[Union[str, torch.device]] = None) -> "QuantileSketch":
        """A :class:`QuantileSketch` on ``device`` (``cuda`` by default)
        preloaded with these counts."""
        sketch = QuantileSketch(bins=self.bins, alpha=self.alpha, device=device)
        sketch.value = torch.tensor(self.counts, dtype=torch.float32, device=sketch.device)
        return sketch

    def snapshot(self) -> dict:
        """Percentile summary (plain floats)."""
        return {
            "count": self.count,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


class HyperLogLog(BaseAggregator):
    """Streaming distinct count over hashed values (HyperLogLog).

    ``m = 2**precision`` int32 registers each hold the largest leading-zero
    rank seen in their substream; the relative standard error is about
    ``1.04 / sqrt(m)``. Values are hashed by their float32 bit pattern.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.streaming import HyperLogLog
        >>> h = HyperLogLog(device="cpu")
        >>> h.update(torch.arange(2000, dtype=torch.float32) % 500)
        >>> bool(abs(float(h.compute()) - 500) < 50)
        True
    """

    full_state_update = False

    def __init__(self, precision: int = 10, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        precision = int(precision)
        if not 4 <= precision <= 16:
            raise ValueError(f"precision must be in [4, 16], got {precision}")
        super().__init__("max", torch.zeros((1 << precision,), dtype=torch.int32), nan_strategy, **kwargs)
        # registers are ranks of at most 32 - precision + 1: bit planes, lossless, so the max is the exact union
        self._quant_state_specs = {"value": quant.QuantCodec("pack", bits=quant.bits_for_bound(32 - precision + 1))}
        self.precision = precision
        self.registers = 1 << precision

    def _ranks(self, value: Tensor, mask: Tensor):
        h = hash_u32(as_u32_bits(_key_bits(torch.where(mask, value, 0.0))))
        idx = h >> (32 - self.precision)
        tail = (h << self.precision) & 0xFFFFFFFF
        rank = torch.where(tail == 0, 32 - self.precision + 1, _clz32(tail) + 1)
        return idx, torch.where(mask, rank, 0).to(torch.int32)  # rank 0 never beats a register

    def update(self, value: Union[float, Tensor]) -> None:
        value, mask = self._cast_and_nan_mask_input(value)
        value, mask = torch.atleast_1d(value), torch.atleast_1d(mask)
        idx, rank = self._ranks(value, mask)
        self.value = self.value.scatter_reduce(0, idx.reshape(-1), rank.reshape(-1), reduce="amax")

    def _masked_update_supported(self) -> bool:
        return True

    def _masked_update(self, sample_mask: Tensor, value: Union[float, Tensor]) -> None:
        value, mask = self._cast_and_nan_mask_input(value)
        value, mask = torch.atleast_1d(value), torch.atleast_1d(mask)
        mask = mask & torch.broadcast_to(torch.atleast_1d(sample_mask), mask.shape)
        idx, rank = self._ranks(value, mask)
        self.value = self.value.scatter_reduce(0, idx.reshape(-1), rank.reshape(-1), reduce="amax")

    def compute(self) -> Tensor:
        m = self.registers
        alpha_m = 0.7213 / (1.0 + 1.079 / m) if m >= 128 else {16: 0.673, 32: 0.697, 64: 0.709}[m]
        regs = self.value.to(torch.float32)
        raw = alpha_m * m * m / torch.sum(torch.pow(2.0, -regs))
        zeros = (self.value == 0).sum().to(torch.float32)
        linear = m * torch.log(m / zeros.clamp(min=1.0))
        return torch.where((raw <= 2.5 * m) & (zeros > 0), linear, raw)


class CountMinHeavyHitters(BaseAggregator):
    """Count-min frequency sketch for heavy-hitter queries.

    A ``(depth, width)`` float32 table; each row hashes every key into one
    of ``width`` counters with its own seed. :meth:`estimate` returns the
    row-wise minimum, an upper bound on the true (weighted) frequency that
    is never an underestimate. An update is one launch of the ``countmin``
    kernel on the card.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.streaming import CountMinHeavyHitters
        >>> c = CountMinHeavyHitters(device="cpu")
        >>> c.update(torch.tensor([7.0, 7.0, 7.0, 3.0]))
        >>> [float(v) for v in c.estimate(torch.tensor([7.0, 3.0]))]
        [3.0, 1.0]
    """

    full_state_update = False
    _device_attributes = ("_seed_bits",)

    def __init__(
        self, depth: int = 4, width: int = 1024, nan_strategy: Union[str, float] = "warn", **kwargs: Any
    ) -> None:
        depth, width = int(depth), int(width)
        if depth <= 0 or width <= 0:
            raise ValueError(f"depth and width must be positive, got depth={depth} width={width}")
        super().__init__("sum", torch.zeros((depth, width), dtype=torch.float32), nan_strategy, **kwargs)
        # ceil codes: each rank's decoded table only over-counts, so the sum never underestimates
        self._quant_state_specs = {"value": quant.QuantCodec("q8", rounding="up")}
        self.depth = depth
        self.width = width
        # one hash seed a row, d * 0x9E3779B9 + 1 mod 2^32, held as int32 bits
        seeds = (torch.arange(depth, dtype=torch.int64) * _SEED_STEP + 1) & 0xFFFFFFFF
        self._seed_bits = torch.where(seeds >= 2**31, seeds - 2**32, seeds).to(torch.int32).to(self.device)

    def _seeds(self) -> Tensor:
        """One independent hash seed per table row (int32 bit patterns)."""
        return self._seed_bits

    def _indices(self, value: Tensor) -> Tensor:
        """(depth, n) column index per key per row."""
        h = hash_u32(as_u32_bits(_key_bits(value))[None, :] ^ as_u32_bits(self._seeds())[:, None])
        return h % self.width

    def _add(self, value: Tensor, weight: Tensor, mask: Tensor) -> None:
        bits = _key_bits(torch.where(mask, value, 0.0))
        w = torch.where(mask, weight, 0.0)
        self.value = countmin_update(self.value, bits, w, self._seeds())

    def update(self, value: Union[float, Tensor], weight: Union[float, Tensor] = 1.0) -> None:
        value, mask = self._cast_and_nan_mask_input(value)
        value, mask = torch.atleast_1d(value), torch.atleast_1d(mask)
        if isinstance(weight, Tensor):
            weight = torch.broadcast_to(weight.to(torch.float32), value.shape)
        else:  # a Python number: filled on the device, no copy from the host
            weight = torch.full_like(value, float(weight))
        self._add(value, weight, mask)

    def _masked_update_supported(self) -> bool:
        return True

    def _masked_update(
        self, sample_mask: Tensor, value: Union[float, Tensor], weight: Union[float, Tensor] = 1.0
    ) -> None:
        value, mask = self._cast_and_nan_mask_input(value)
        value, mask = torch.atleast_1d(value), torch.atleast_1d(mask)
        mask = mask & torch.broadcast_to(torch.atleast_1d(sample_mask), mask.shape)
        if isinstance(weight, Tensor):
            weight = torch.broadcast_to(weight.to(torch.float32), value.shape)
        else:
            weight = torch.full_like(value, float(weight))
        self._add(value, weight, mask)

    def estimate(self, keys: Union[float, Tensor]) -> Tensor:
        """Frequency upper bound per key (scalar or vector)."""
        keys = torch.as_tensor(keys, dtype=torch.float32, device=self.device)
        idx = self._indices(torch.atleast_1d(keys).reshape(-1))
        rows = torch.arange(self.depth, device=self.device)[:, None]
        return self.value[rows, idx].amin(dim=0).reshape(keys.shape)

    def compute(self) -> Tensor:
        """Total weight absorbed (every row sums to it; row 0 is read)."""
        return self.value[0].sum()
