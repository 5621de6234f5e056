"""Count-min sketch update: the ``countmin`` kernel, and the sketches' hash.

Port of ``metrics_tpu/ops/sketch_ops.py``. :func:`countmin_update` adds
``w[i]`` at ``(d, hash_u32(bits[i] ^ seeds[d]) % width)`` of a
``(depth, width)`` float32 table for every key ``i`` and row ``d``. On a
CUDA tensor the hash and the adds run in the hand-written kernel in
``csrc/countmin.cu``, which sums the keys of a warp that hit the same cell
before it adds; on a CPU tensor in :func:`_countmin_plain`, one
``index_add_`` after the hash. :func:`countmin_plan` sizes the launch: a
table that fits a block's shared memory is added per warp in shared memory
on one block an SM and reduced in a fixed order (deterministic, no atomics),
a wider one with global atomics.

The session axis, :func:`countmin_update_sessions`, is what ``jax.vmap``
makes of the update in the JAX service's flush (``metrics_tpu/serve.py:1493``):
``(S, depth, width)`` tables, each with its own ``(S, n)`` keys and weights
under one set of seeds, in one launch (branch ``"sessions"``: a block a
session, its warps' tables in shared memory summed in a fixed order; or
``"sessions-global"``: global atomics, for tables past the shared limit). Its
plain version is one ``index_add_`` over the ``S * depth * width`` cells.

PyTorch has no full uint32 arithmetic on the CPU, so the port carries a
uint32 bit pattern in an int32 tensor (``torch.uint32`` inputs are viewed
the same way) and :func:`hash_u32` computes in int64, masking to 32 bits
after every multiply: the products stay below 2^59, so it is exact.
"""
import ctypes
import functools
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.ops import _build, registry

_NAME = "countmin"
registry.register(_NAME, "cuda", ("CountMin",),
                  "count-min hash and add into per-warp shared tables (csrc/countmin.cu)")
_MASK = 0xFFFFFFFF
_MULT = 0x45D9F3B
_MAX_WARPS = 8  # a block of the shared branch: one private table a warp
_KEYS_PER_BLOCK = 512  # the fewest keys a block of the shared branch is given
_GLOBAL_THREADS = 256


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("countmin")
    lib.countmin_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    lib.countmin_launch.restype = ctypes.c_int
    lib.countmin_sessions_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    lib.countmin_sessions_launch.restype = ctypes.c_int
    lib.countmin_error_string.argtypes = [ctypes.c_int]
    lib.countmin_error_string.restype = ctypes.c_char_p
    return lib


def as_u32_bits(x: Tensor) -> Tensor:
    """A 32-bit integer tensor (int32 or uint32) as its uint32 values in int64."""
    if x.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"expected 32-bit key bits (torch.int32 or torch.uint32), got {x.dtype}")
    return x.view(torch.int32).to(torch.int64) & _MASK


def hash_u32(x: Tensor) -> Tensor:
    """The sketches' 32-bit avalanche finalizer (xor-shift-multiply) on
    uint32 values held in int64; returns int64 values in ``[0, 2^32)``."""
    x = x & _MASK
    x = ((x ^ (x >> 16)) * _MULT) & _MASK
    x = ((x ^ (x >> 16)) * _MULT) & _MASK
    return x ^ (x >> 16)


def _countmin_plain(value: Tensor, bits: Tensor, w: Tensor, seeds: Tensor) -> Tensor:
    """The hash for every (row, key), then one ``index_add_`` on the flat table."""
    depth, width = value.shape
    h = hash_u32(as_u32_bits(bits)[None, :] ^ as_u32_bits(seeds)[:, None])
    flat = (h % width) + torch.arange(depth, device=value.device)[:, None] * width
    weights = w.to(torch.float32)[None, :].expand(depth, -1)
    out = value.to(torch.float32).clone().reshape(-1)
    out.index_add_(0, flat.reshape(-1), weights.reshape(-1))
    return out.reshape(depth, width)


def _countmin_kernel(value: Tensor, bits: Tensor, w: Tensor, seeds: Tensor) -> Tensor:
    """Launch ``csrc/countmin.cu`` on canonical CUDA inputs."""
    for name, x, dtype, ndim in (
        ("value", value, torch.float32, 2),
        ("bits", bits, torch.int32, 1),
        ("w", w, torch.float32, 1),
        ("seeds", seeds, torch.int32, 1),
    ):
        if x.dtype != dtype:
            raise TypeError(f"countmin_update: `{name}` must be {dtype}, got {x.dtype}")
        if x.ndim != ndim:
            raise ValueError(f"countmin_update: `{name}` must be {ndim}-D, got shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"countmin_update: `{name}` must be contiguous")
    depth, width = value.shape
    n = bits.shape[0]
    if w.shape[0] != n or seeds.shape[0] != depth:
        raise ValueError(
            f"countmin_update: {n} keys with {w.shape[0]} weights, and {seeds.shape[0]} seeds for {depth} rows"
        )
    if n >= 2**31 or depth * width >= 2**31:
        raise ValueError(f"countmin_update: {n} keys into ({depth}, {width}) is beyond the kernel's int32 indexing")
    if n == 0:
        return value.clone()
    lib = _lib()
    branch, blocks, warps = countmin_plan(n, depth, width, *_device_limits(value.device))
    out = torch.empty_like(value)
    workspace = (torch.empty(blocks * depth * width, dtype=torch.float32, device=value.device)
                 if branch == "shared" else None)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        err = lib.countmin_launch(
            bits.data_ptr(), w.data_ptr(), seeds.data_ptr(), n, depth, width, value.data_ptr(), out.data_ptr(),
            None if workspace is None else workspace.data_ptr(), blocks, warps, stream,
        )
    if err != 0:
        raise RuntimeError(f"countmin kernel launch failed: {lib.countmin_error_string(err).decode()}")
    # the Hopper kernel's terms (chip_smoke.py's bound): keys and weights read (4 B each), the seeds read, the
    # (depth, width) table read and written; the hash (9 operations), the modulo and the add a key and row. The
    # JAX formula's 3n·depth·width flops are the TPU's one-hot sweep (ops/sketch_ops.py:128).
    registry.note_launch(_NAME, branch, (n, depth, width), cost_key=(n, depth, width),
                         flops=11.0 * n * depth, bytes_accessed=8.0 * n + 4.0 * depth + 8.0 * depth * width)
    return out


def countmin_plan(n: int, depth: int, width: int, sms: int, shared_optin: int) -> Tuple[str, int, int]:
    """``(branch, blocks, warps)`` of the kernel's launch for ``n`` keys into a
    ``(depth, width)`` table, on a device of ``sms`` SMs whose blocks may use
    ``shared_optin`` bytes of shared memory.

    ``"shared"`` when one table (its stride rounded up to whole float4s) and
    a warp's 32 staged weights fit that limit: up to 8 warps a block, each
    with its own table, and one block an SM, fewer when a block would get
    fewer than 512 keys. Otherwise ``"global"``: blocks of 256 threads, one
    a 256 keys, at most 8 an SM.
    """
    warps = min(_MAX_WARPS, shared_optin // (4 * (-(-depth * width // 4) * 4 + 32)))
    if warps >= 1:
        return "shared", max(1, min(sms, -(-n // _KEYS_PER_BLOCK))), warps
    return "global", max(1, min(8 * sms, -(-n // _GLOBAL_THREADS))), _GLOBAL_THREADS // 32


def _device_limits(device: torch.device) -> Tuple[int, int]:
    """The SM count and the opt-in shared memory a block may use on ``device``."""
    return registry.device_limits(device, _lib(), _NAME)


def countmin_uses_shared(depth: int, width: int, device: torch.device) -> bool:
    """Whether the kernel adds a ``(depth, width)`` table in shared memory on ``device``."""
    return countmin_plan(1, depth, width, *_device_limits(torch.device(device)))[0] == "shared"


def countmin_update(value: Tensor, bits: Tensor, w: Tensor, seeds: Tensor) -> Tensor:
    """New ``(depth, width)`` count-min table after absorbing one batch.

    ``bits`` are the keys' 32-bit patterns ``(n,)`` and ``seeds`` one per
    table row, both int32 or uint32; ``w`` the per-key weights (0 for masked
    keys). Bit-identical between the kernel and the plain version, and to
    the JAX package's scatter, for integral weights; other weights agree to
    float32 rounding. The kernel's shared-memory branch adds in a fixed order,
    so it gives the same bits on every call on one device.
    """
    if value.ndim != 2 or bits.ndim != 1 or w.shape != bits.shape or seeds.shape != value.shape[:1]:
        raise ValueError(
            "countmin_update expects a (depth, width) `value`, (n,) `bits` and `w` and (depth,) `seeds`, got"
            f" {tuple(value.shape)}, {tuple(bits.shape)}, {tuple(w.shape)} and {tuple(seeds.shape)}"
        )
    if not registry.use_kernel(value, bits, w, seeds):
        return _countmin_plain(value, bits, w, seeds)
    for name, x in (("bits", bits), ("seeds", seeds)):
        if x.dtype not in (torch.int32, torch.uint32):
            raise TypeError(f"countmin_update: `{name}` must be int32 or uint32, got {x.dtype}")
    return _countmin_kernel(
        value.to(torch.float32).contiguous(),
        bits.view(torch.int32).contiguous(),
        w.to(torch.float32).contiguous(),
        seeds.view(torch.int32).contiguous(),
    )


def _countmin_sessions_plain(values: Tensor, bits: Tensor, w: Tensor, seeds: Tensor) -> Tensor:
    """:func:`_countmin_plain` on each of S tables, as one ``index_add_`` over
    the ``S * depth * width`` cells."""
    sessions, depth, width = values.shape
    h = hash_u32(as_u32_bits(bits)[:, None, :] ^ as_u32_bits(seeds)[None, :, None])  # (S, depth, n)
    flat = ((h % width) + torch.arange(depth, device=values.device)[None, :, None] * width
            + torch.arange(sessions, device=values.device)[:, None, None] * (depth * width))
    weights = w.to(torch.float32)[:, None, :].expand(-1, depth, -1)
    out = values.to(torch.float32).clone().reshape(-1)
    out.index_add_(0, flat.reshape(-1), weights.reshape(-1))
    return out.reshape(sessions, depth, width)


def countmin_sessions_plan(sessions: int, n: int, depth: int, width: int, sms: int,
                           shared_optin: int) -> Tuple[str, int, int]:
    """``(branch, blocks, warps)`` of the session axis for ``sessions`` tables
    of ``(depth, width)`` with ``n`` keys each: ``"sessions"`` when a table
    (its stride rounded up to whole float4s) and a warp's 32 staged weights
    fit ``shared_optin`` bytes, one block a session; else
    ``"sessions-global"``, blocks of 256 threads over every session's keys, at
    most 8 an SM.

    A block's warps (up to 8, no more than its keys fill) are those that take
    the fewest rounds of keys times waves of blocks, the most warps on a tie.
    An SM holds as many blocks as its 2,048 threads and its shared memory
    allow: ``shared_optin`` and the 1 KB the runtime keeps a block, which is
    the SM's whole on sm_80 and sm_90. At 256 tables of 4 x 1024 with 4,096
    keys each that is 7 warps, two blocks an SM, one wave: 63.5 µs on an H100
    against 100.1 µs for 8 warps, one block an SM in two waves
    (``tools/torch_countmin_sweep.py``)."""
    table = 4 * (-(-depth * width // 4) * 4 + 32)
    most = min(_MAX_WARPS, shared_optin // table, max(1, -(-n // 32)))
    if most < 1:
        return "sessions-global", max(1, min(8 * sms, -(-(sessions * n) // _GLOBAL_THREADS))), 0

    def rounds(warps: int) -> int:
        per_sm = min((shared_optin + 1024) // (warps * table + 1024), 2048 // (32 * warps))
        return -(-sessions // (sms * per_sm)) * -(-n // (32 * warps))

    return "sessions", sessions, min(range(most, 0, -1), key=rounds)


def countmin_sessions_branch(sessions: int, n: int, depth: int, width: int, device: torch.device) -> str:
    """The branch the session axis takes for these sizes on CUDA ``device``."""
    return countmin_sessions_plan(sessions, n, depth, width, *_device_limits(torch.device(device)))[0]


def _countmin_sessions_kernel(values: Tensor, bits: Tensor, w: Tensor, seeds: Tensor) -> Tensor:
    """Launch the session axis of ``csrc/countmin.cu`` on canonical CUDA inputs."""
    for name, x, dtype, ndim in (
        ("values", values, torch.float32, 3),
        ("bits", bits, torch.int32, 2),
        ("w", w, torch.float32, 2),
        ("seeds", seeds, torch.int32, 1),
    ):
        if x.dtype != dtype:
            raise TypeError(f"countmin_update_sessions: `{name}` must be {dtype}, got {x.dtype}")
        if x.ndim != ndim:
            raise ValueError(f"countmin_update_sessions: `{name}` must be {ndim}-D, got shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"countmin_update_sessions: `{name}` must be contiguous")
    sessions, depth, width = values.shape
    n = bits.shape[1]
    if bits.shape[0] != sessions or w.shape != bits.shape or seeds.shape[0] != depth:
        raise ValueError(
            f"countmin_update_sessions: {tuple(bits.shape)} keys with {tuple(w.shape)} weights into "
            f"{tuple(values.shape)} tables, and {seeds.shape[0]} seeds"
        )
    if sessions * n >= 2**31 or sessions * depth * width >= 2**31:
        raise ValueError(
            f"countmin_update_sessions: {sessions} x {n} keys into {tuple(values.shape)} is beyond the kernel's"
            " int32 indexing"
        )
    lib = _lib()
    branch, blocks, warps = countmin_sessions_plan(sessions, n, depth, width, *_device_limits(values.device))
    out = torch.empty_like(values)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = lib.countmin_sessions_launch(
            bits.data_ptr(), w.data_ptr(), seeds.data_ptr(), sessions, n, depth, width, values.data_ptr(),
            out.data_ptr(), warps, blocks, stream,
        )
    if err != 0:
        raise RuntimeError(f"countmin session-axis launch failed: {lib.countmin_error_string(err).decode()}")
    # the single table's terms (countmin_update) for S tables: keys and weights read, the seeds read, every table
    # read and written; the hash, the modulo and the add a key and row
    registry.note_launch(_NAME, branch, (sessions, n, depth, width), cost_key=("sessions", sessions, n, depth, width),
                         flops=11.0 * sessions * n * depth,
                         bytes_accessed=8.0 * sessions * n + 4.0 * depth + 8.0 * sessions * depth * width)
    return out


def countmin_update_sessions(values: Tensor, bits: Tensor, w: Tensor, seeds: Tensor) -> Tensor:
    """New ``(S, depth, width)`` tables after each absorbs its own batch:
    :func:`countmin_update` on every session at once.

    ``bits`` ``(S, n)`` are the keys' 32-bit patterns and ``seeds`` ``(depth,)``
    one per table row (int32 or uint32); ``w`` ``(S, n)`` the weights (0 for
    masked keys). Bit-identical between the kernel, the plain version and the
    JAX package's vmapped ``countmin_update`` for integral weights; other
    weights are summed in another order and agree to float32 rounding (the
    kernel's sessions branch gives the same bits on every call on one device).
    """
    if values.ndim != 3 or bits.ndim != 2 or w.shape != bits.shape or bits.shape[0] != values.shape[0] \
            or seeds.shape != values.shape[1:2]:
        raise ValueError(
            "countmin_update_sessions expects (S, depth, width) `values`, (S, n) `bits` and `w` and (depth,) "
            f"`seeds`, got {tuple(values.shape)}, {tuple(bits.shape)}, {tuple(w.shape)} and {tuple(seeds.shape)}"
        )
    if not registry.use_kernel(values, bits, w, seeds):
        return _countmin_sessions_plain(values, bits, w, seeds)
    for name, x in (("bits", bits), ("seeds", seeds)):
        if x.dtype not in (torch.int32, torch.uint32):
            raise TypeError(f"countmin_update_sessions: `{name}` must be int32 or uint32, got {x.dtype}")
    return _countmin_sessions_kernel(
        values.to(torch.float32).contiguous(),
        bits.view(torch.int32).contiguous(),
        w.to(torch.float32).contiguous(),
        seeds.view(torch.int32).contiguous(),
    )
