"""The fused bucketed sync: one collective per (wire dtype, reduce op) bucket.

Port of ``metrics_tpu/sync_engine.py:1-612``. A per-leaf sync issues one
collective for each state leaf, so a collection of K metrics with L leaves
pays K·L round trips a ``compute``. Here every fixed-shape leaf whose
reduction is one of the four named ops (within one metric, or across every
compute-group leader of a collection) is packed into one flat buffer per
``(wire dtype, op)`` bucket, one collective runs per bucket, and the result is
unpacked in the leaves' planning order.

* Eligible: tensor states reduced by ``sum``, ``mean``, ``max`` or ``min``
  with exact packed semantics: floats take every op; integers take sum, max
  and min (an integer ``mean`` keeps the per-leaf path's float32 promotion);
  bools take max and min and cross as int32.
* Everything else (list states, ``cat`` states, custom reductions, custom
  ``dist_sync_fn`` gathers, ragged states) keeps the per-leaf protocol,
  issued after the buckets in the same order on every rank.

``sync_dtype`` narrows each packed float buffer once; such a bucket is
gathered narrow and reduced at full precision after the cast back. A bucket
of the wire's own dtype takes ``env.all_reduce``, or one gather and a local
reduce where the env has no native reduction.

With ``sync_precision="int8"`` the eligible buckets cross the quantised
wire (:mod:`metrics_tpu_torch.quant`): one gather of one uint8 payload, each
rank decoding before it reduces at full precision. A bucket too small to
shrink crosses at full precision; a codec failure demotes the bucket to the
full-precision wire (a ``quant-sync`` degrade). ``METRICS_TPU_QUANT_SYNC=0``
turns the quantised wire off.

Leaves declared ``add_state(shard_state=group)`` form a third class of
bucket (``rs[<group>]:`` keys): under a :class:`~metrics_tpu_torch.parallel.ProcessEnv`
over that group, one ``reduce_scatter_tensor`` per sum or mean bucket leaves
each rank only its own ``d0/N`` rows; max, min and quantised sharded buckets
trade shard blocks with one ``all_to_all_single`` and reduce locally. Under
any other env, or with ``METRICS_TPU_SHARD_STATE=0``, the leaves sync
replicated.

``METRICS_TPU_FUSED_SYNC=0`` restores the per-leaf protocol. Every bucket is
counted in its owner's ``sync_stats``: ``collectives``, ``buckets``,
``sharded_buckets``, ``bytes_on_wire`` and ``bytes_logical``.

Each bucket emits one ``collective`` span (kind ``fused``) with its
``nbytes`` on the wire and ``logical_nbytes`` (``metrics_tpu/sync_engine.py:
442-480, 570-585``); while a session listens it carries the cost attributes
of a ``sync`` entry of :mod:`metrics_tpu_torch.analysis.cost_model` whose
bytes are the bucket's wire bytes (the JAX package lowers a probe program
for its entry; a collective's model cost here is its bytes, no flops).

The fleet reads (``metrics_tpu/sync_engine.py:600-811``) are the read-side
twin of the buckets: :func:`build_fleet_read` gathers the requested session
rows of every shard of a :class:`~metrics_tpu_torch.fabric.ShardedMetricsService`
into one byte-packed buffer (leaves of mixed dtypes cross as raw bytes,
``Tensor.view(torch.uint8)``: exact), unpacks it per leaf and evaluates every
row; :func:`build_fleet_rollup` folds the rows into one state (pad lanes add
nothing) and computes it once. Under ``sync_precision`` a float leaf may
cross as q8 codes and scales (:mod:`metrics_tpu_torch.quant`). On the card
the fabric captures each into one CUDA graph.
"""
import os
import time
from typing import Any, Callable, Dict, Hashable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor

from metrics_tpu_torch import faults, quant, resilience, telemetry
from metrics_tpu_torch.analysis import cost_model
from metrics_tpu_torch.utilities.data import dim_zero_max, dim_zero_mean, dim_zero_min, dim_zero_sum, dtype_name

# reductions that are one named collective op (the contract metric.py's per-leaf path shares)
NATIVE_REDUCE_OPS = {
    dim_zero_sum: "sum",
    dim_zero_mean: "mean",
    dim_zero_max: "max",
    dim_zero_min: "min",
}

_HOST_REDUCE = {"sum": dim_zero_sum, "mean": dim_zero_mean, "max": dim_zero_max, "min": dim_zero_min}


def _switch(name: str) -> bool:
    return os.environ.get(name, "1").strip().lower() not in ("0", "false", "off")


def fused_sync_enabled() -> bool:
    """Whether the bucketed sync is on (default yes); ``METRICS_TPU_FUSED_SYNC=0``
    (or ``false``/``off``) restores the per-leaf protocol."""
    return _switch("METRICS_TPU_FUSED_SYNC")


def shard_state_enabled() -> bool:
    """Whether ``add_state(shard_state=...)`` is honoured (default yes);
    ``METRICS_TPU_SHARD_STATE=0`` syncs every leaf replicated at its full shape."""
    return _switch("METRICS_TPU_SHARD_STATE")


def group_label(group: Any) -> str:
    """A name for a process group that every rank agrees on: ``world`` for
    the default group, else its ranks."""
    if group == "world" or group is None or group is dist.group.WORLD:
        return "world"
    return "ranks" + ",".join(str(r) for r in dist.get_process_group_ranks(group))


class LeafSpec(NamedTuple):
    """One fixed-shape leaf scheduled into a bucket. ``key`` routes the result
    back (the state's name for one metric, ``(tag, name)`` in a collection's
    pass); ``shape`` is the shape after sync (a scalar state becomes ``(1,)``,
    as on the per-leaf path); ``codec`` the quantised wire or None;
    ``shard_group`` the group its leading dim shards over, or None."""

    key: Hashable
    value: Tensor
    op: str
    wire_dtype: torch.dtype
    dtype: torch.dtype
    shape: Tuple[int, ...]
    codec: Optional[quant.QuantCodec] = None
    shard_group: Any = None


def _is_integer(dt: torch.dtype) -> bool:
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)


def plan_metric_leaves(metric: Any, states: Dict[str, Any], tag: Optional[Hashable] = None) -> List[LeafSpec]:
    """The bucket-eligible leaves of ``metric`` among ``states``, by the
    metric's own policy: its reductions pick the op, ``sync_dtype`` the
    narrower wire of wide float leaves (never of raw-sample states, which
    would stay narrowed), ``sync_precision`` the quantised wire (with the
    per-leaf opt-out and the sketches' own codecs), ``shard_state`` the
    sharded class. Leaves not returned stay on the per-leaf path."""
    specs: List[LeafSpec] = []
    sync_dtype = metric.sync_dtype
    sample_names = getattr(metric, "_sample_state_names", ()) or ()
    ragged = getattr(metric, "_ragged_state_specs", None) or {}
    quant_on = getattr(metric, "sync_precision", None) is not None and quant.quant_enabled()
    quant_optout = getattr(metric, "_quantize", None) or {}
    quant_native = getattr(metric, "_quant_state_specs", None) or {}
    sharded = (getattr(metric, "_shard_state", None) or {}) if shard_state_enabled() else {}
    for attr, value in states.items():
        if isinstance(value, list) or attr in ragged or not isinstance(value, Tensor):
            continue
        op = NATIVE_REDUCE_OPS.get(metric._reductions[attr])
        if op is None:
            continue
        dt = value.dtype
        codec = None
        shard_group = sharded.get(attr) if value.ndim >= 1 else None
        if dt == torch.bool:
            if op not in ("max", "min"):
                continue  # a bool sum counts in int32: the per-leaf path's semantics
            wire = torch.int32
        elif dt.is_floating_point:
            wire = dt
            # sharded leaves keep their dtype: the reduce-scatter accumulates in the wire's dtype
            if sync_dtype is not None and attr not in sample_names and shard_group is None \
                    and dt.itemsize > sync_dtype.itemsize:
                wire = sync_dtype
        elif _is_integer(dt):
            if op == "mean":
                continue  # an integer mean keeps the per-leaf path's float32 promotion
            wire = dt
        else:
            continue  # complex stays on the per-leaf path
        if quant_on and quant_optout.get(attr, True) and attr not in sample_names:
            codec = quant_native.get(attr)
            if codec is None and dt.is_floating_point:
                codec = quant.QuantCodec("q8")
                wire = dt  # the quantised wire supersedes sync_dtype
            elif codec is None and _is_integer(dt) and dt.itemsize > 1:
                codec = quant.QuantCodec("q8")  # exact below quant.INT_EXACT_BOUND a block
        specs.append(LeafSpec(
            key=attr if tag is None else (tag, attr),
            value=value,
            op=op,
            wire_dtype=wire,
            dtype=dt,
            shape=tuple(value.shape) or (1,),
            codec=codec,
            shard_group=shard_group,
        ))
    return specs


def bucket_plan(specs: List[LeafSpec]) -> Dict[Tuple[str, str], List[LeafSpec]]:
    """The planned leaves grouped into ``(wire label, op)`` buckets: the
    collective schedule, one collective a bucket in sorted key order."""
    buckets: Dict[Tuple[str, str], List[LeafSpec]] = {}
    for s in specs:
        tag = quant.wire_tag(s.codec, dtype_name(s.wire_dtype))
        if s.shard_group is not None:
            tag = f"rs[{group_label(s.shard_group)}]:{tag}"
        buckets.setdefault((tag, s.op), []).append(s)
    return buckets


def shards_group(env: Any, declared: Any) -> bool:
    """Whether ``env`` shards the leaves declared ``shard_state=declared``:
    its ``shard_group`` must be that group (the JAX package's matching mesh
    axis); ``"world"`` is the default group."""
    group = getattr(env, "shard_group", None)
    if declared is None or group is None:
        return False
    return group_label(group) == "world" if declared == "world" else declared is group


def _shard_world(env: Any, declared: Any) -> Optional[int]:
    """The world of a sharded bucket, or None where the env cannot shard it."""
    return int(env.world_size()) if shards_group(env, declared) else None


def _logical_nbytes(leaves: List[LeafSpec]) -> int:
    return sum(_numel(s.shape) * (1 if s.dtype == torch.bool else s.dtype.itemsize) for s in leaves)


def _numel(shape: Tuple[int, ...]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _execute_sharded(env: Any, leaves: List[LeafSpec], n: int, op: str, wire: torch.dtype,
                     codec: Optional[quant.QuantCodec], out: Dict[Hashable, Tensor]) -> int:
    """One collective for a sharded bucket; each rank keeps its own reduced
    rows. Returns the payload's bytes a rank.

    The leaves pack shard-major into an ``(n, M)`` buffer (row ``r`` holds
    shard ``r`` of every leaf). Sum and mean at full precision take one
    ``reduce_scatter``; max, min and quantised buckets one ``all_to_all``,
    each rank decoding and reducing its blocks at full precision."""
    pers = [s.shape[0] // n for s in leaves]
    tails = [_numel(s.shape[1:]) for s in leaves]
    mats = [s.value.to(wire).reshape(n, p * t) for s, p, t in zip(leaves, pers, tails)]
    buf2d = mats[0] if len(mats) == 1 else torch.cat(mats, dim=1)
    m = int(buf2d.shape[1])

    def _unpack(red_or_stack: Tensor, stacked: bool) -> None:
        off = 0
        for s, p, t in zip(leaves, pers, tails):
            shard_shape = (p,) + s.shape[1:]
            if stacked:
                seg = red_or_stack[:, off:off + p * t]
                if codec is not None and codec.kind == "q8" and _is_integer(s.dtype):
                    seg = torch.round(seg).to(s.dtype)  # integers back on the lattice before the reduction
                else:
                    seg = seg.to(s.dtype)
                out[s.key] = _HOST_REDUCE[op](seg).to(s.dtype).reshape(shard_shape)
            else:
                out[s.key] = red_or_stack[off:off + p * t].to(s.dtype).reshape(shard_shape)
            off += p * t

    if codec is not None:
        block = quant.default_block(wire)
        payload = torch.stack([quant.encode_bucket(r, codec, block=block) for r in buf2d])
        swapped = env.all_to_all(payload)
        decoded = torch.stack([quant.decode_bucket(p, codec, m, block=block) for p in swapped])
        _unpack(decoded, stacked=True)
        return int(payload.numel())
    if op in ("sum", "mean"):
        red = env.reduce_scatter(buf2d)
        if op == "mean":
            red = red / n
        _unpack(red, stacked=False)
    else:
        _unpack(env.all_to_all(buf2d), stacked=True)
    return int(buf2d.numel()) * wire.itemsize


def _account(stats: Optional[Dict[str, int]], owner: str, t0: float, leaves: List[LeafSpec], wire_name: str, op: str,
             nbytes: int, logical: int, codec: Optional[quant.QuantCodec], sharded: Optional[int] = None) -> None:
    """One bucket's ``collective`` span (the cost attributes only while a
    session listens) and its counts in ``stats``; ``sharded`` is the world a
    sharded bucket split over."""
    attrs: Dict[str, Any] = {}
    if sharded is not None:
        attrs = {"sharded": True, "shard_world": sharded, "shard_nbytes": logical // sharded}
    if telemetry.subscribed():
        key = (owner, wire_name, op, tuple((s.shape, dtype_name(s.dtype)) for s in leaves))
        entry = cost_model.record_static(owner, "sync", key, flops=0.0, bytes_accessed=nbytes)
        attrs.update(cost_model.launch_attrs(entry, (time.perf_counter() - t0) * 1e6))
    # quantized: whether the payload crossed on the int8 wire (False after a too-small or demoted bucket)
    telemetry.emit("collective", owner, "fused", t0=t0, nbytes=nbytes, logical_nbytes=logical, op=op,
                   wire_dtype=wire_name, quantized=codec is not None, nleaves=len(leaves), **attrs)
    if stats is None:
        return
    stats["collectives"] = stats.get("collectives", 0) + 1
    stats["buckets"] = stats.get("buckets", 0) + 1
    if sharded is not None:
        stats["sharded_buckets"] = stats.get("sharded_buckets", 0) + 1
    stats["bytes_on_wire"] = stats.get("bytes_on_wire", 0) + nbytes
    stats["bytes_logical"] = stats.get("bytes_logical", 0) + logical


def execute_buckets(
    env: Any,
    specs: List[LeafSpec],
    owner: str = "Metric",
    stats: Optional[Dict[str, int]] = None,
) -> Dict[Hashable, Tensor]:
    """One collective per bucket; returns ``{key: reduced}``.

    Buckets run in sorted ``(wire label, op)`` order and leaves keep their
    planning order within a bucket, so every rank issues the same sequence of
    collectives. The results are new tensors: no state buffer is written.
    """
    if not specs:
        return {}
    buckets = bucket_plan(specs)
    out: Dict[Hashable, Tensor] = {}
    for wire_name, op in sorted(buckets):
        t0 = time.perf_counter()
        leaves = buckets[(wire_name, op)]
        codec = leaves[0].codec
        wire = leaves[0].wire_dtype
        logical_nbytes = _logical_nbytes(leaves)

        n_shard = _shard_world(env, leaves[0].shard_group)
        if n_shard is not None and all(s.shape[0] % n_shard == 0 for s in leaves):
            try:
                nbytes = _execute_sharded(env, leaves, n_shard, op, wire, codec, out)
            except Exception as err:  # noqa: BLE001 -- the replicated branches below serve the bucket
                if not resilience.resilience_enabled():
                    raise
                resilience.record_degrade(owner, "shard-sync", err)
            else:
                _account(stats, owner, t0, leaves, wire_name, op, nbytes, logical_nbytes, codec, sharded=n_shard)
                continue

        buf = torch.cat([s.value.reshape(-1).to(wire) for s in leaves])
        sizes = [_numel(s.shape) for s in leaves]
        offsets = [0]
        for size in sizes:
            offsets.append(offsets[-1] + size)
        nbytes = int(buf.numel()) * wire.itemsize

        if codec is not None and quant.bucket_wire_nbytes(int(buf.numel()), codec) >= nbytes:
            codec = None  # block padding and scales would not shrink this bucket: full precision, no degrade
        if codec is not None:
            try:
                faults.check("quant-corruption", f"sync_engine.bucket:{wire_name}:{op}")
                payload = quant.encode_bucket(buf, codec)
                stacked = torch.stack([quant.decode_bucket(g.reshape(-1), codec, int(buf.numel()))
                                       for g in env.all_gather_uniform(payload)])
                for s, o, k in zip(leaves, offsets, sizes):
                    seg = stacked[:, o:o + k]
                    if codec.kind == "q8" and _is_integer(s.dtype):
                        seg = torch.round(seg).to(s.dtype)  # integers back on the lattice before the reduction
                    else:
                        seg = seg.to(s.dtype)
                    out[s.key] = _HOST_REDUCE[op](seg).to(s.dtype).reshape(s.shape)
                nbytes = int(payload.numel())
            except Exception as err:  # noqa: BLE001 -- this bucket crosses at full precision below
                if not resilience.resilience_enabled():
                    raise
                resilience.record_degrade(owner, "quant-sync", err)
                codec = None

        if codec is None:
            # compressed: a float leaf crosses narrower than its dtype, so it is reduced at full precision
            # after the cast back, never by the native all_reduce (which reduces in the wire's dtype)
            compressed = any(s.dtype.is_floating_point and s.dtype != wire for s in leaves)
            if compressed:
                stacked = torch.stack([g.reshape(-1) for g in env.all_gather_uniform(buf)])
                for s, o, k in zip(leaves, offsets, sizes):
                    out[s.key] = _HOST_REDUCE[op](stacked[:, o:o + k].to(s.dtype)).reshape(s.shape)
            else:
                reduced = env.all_reduce(buf, op)
                if reduced is None:
                    stacked = torch.stack([g.reshape(-1) for g in env.all_gather_uniform(buf)])
                    reduced = _HOST_REDUCE[op](stacked).to(wire)
                reduced = reduced.reshape(-1)
                for s, o, k in zip(leaves, offsets, sizes):
                    # bool leaves rode the wire as int32
                    out[s.key] = reduced[o:o + k].to(s.dtype).reshape(s.shape)
            nbytes = int(buf.numel()) * wire.itemsize
        _account(stats, owner, t0, leaves, wire_name, op, nbytes, logical_nbytes, codec)
    return out


# --------------------------------------------------------- fleet reads
# A fleet read gathers the requested session rows of every shard into one byte-packed buffer (one concatenation),
# then unpacks it per leaf and evaluates every row. Leaves of mixed dtypes share the buffer as raw bytes: a
# reinterpretation, never a value cast.


def _to_wire_bytes(x: Tensor) -> Tensor:
    """``x`` as its uint8 bytes, flat (exact). bool crosses as one byte an element."""
    if x.dtype == torch.bool:
        return x.reshape(-1).to(torch.uint8)
    return x.contiguous().reshape(-1).view(torch.uint8)


def _from_wire_bytes(flat: Tensor, shape: Tuple[int, ...], dtype: torch.dtype) -> Tensor:
    """Inverse of :func:`_to_wire_bytes` from a flat uint8 segment."""
    if dtype == torch.bool:
        return flat.reshape(shape).to(torch.bool)
    itemsize = torch.empty((), dtype=dtype).element_size()
    if flat.storage_offset() % itemsize:
        flat = flat.clone()  # a dtype view needs an aligned start
    return flat.view(dtype).reshape(shape)


def _fleet_codec(template: Any, name: str, dt: torch.dtype) -> Optional[quant.QuantCodec]:
    """The fleet wire's codec for one leaf (``None``: full precision): q8 for a
    float leaf of a template with ``sync_precision``, unless the leaf opted out
    (``add_state(quantize=False)``) or ``METRICS_TPU_QUANT_SYNC=0``."""
    if getattr(template, "sync_precision", None) is None or not quant.quant_enabled():
        return None
    if not (getattr(template, "_quantize", None) or {}).get(name, True):
        return None
    if dt.is_floating_point:
        return quant.QuantCodec("q8")
    return None


def _leaf_wire_specs(
    template: Any, names: List[str], m: Optional[int] = None
) -> List[Tuple[str, Tuple[int, ...], torch.dtype, int, Optional[quant.QuantCodec]]]:
    """``(name, row shape, dtype, full-precision wire bytes a row, codec)`` for
    every state leaf. A codec needs the session bucket ``m`` (a leaf whose q8
    segment would not be smaller crosses at full precision), so ``m=None``
    always gives full precision."""
    defaults = template.default_state()
    specs = []
    for k in names:
        d = defaults[k]
        dt = d.dtype
        itemsize = 1 if dt == torch.bool else d.element_size()
        row_elems = int(np.prod(tuple(d.shape), dtype=np.int64))
        codec = None if m is None else _fleet_codec(template, k, dt)
        if codec is not None:
            count = row_elems * m
            if quant.bucket_wire_nbytes(count, codec) >= count * itemsize:
                codec = None  # quantizing this leaf would inflate the wire
        specs.append((k, tuple(d.shape), dt, row_elems * itemsize, codec))
    return specs


def fleet_wire_sig(specs: List[Tuple]) -> Tuple[str, ...]:
    """Per-leaf wire tags: part of a fleet program's key, so a codec change
    never reuses a stale program."""
    return tuple(quant.wire_tag(c, dtype_name(dt)) for _k, _sh, dt, _rb, c in specs)


def fleet_wire_nbytes(specs: List[Tuple], n_shards: int, m: int) -> int:
    """The bytes one fleet read packs."""
    total = 0
    for _k, shape, _dt, row_bytes, codec in specs:
        if codec is None:
            total += row_bytes * n_shards * m
        else:
            count = int(np.prod(shape, dtype=np.int64)) * m
            total += quant.bucket_wire_nbytes(count, codec) * n_shards
    return total


def _pack_fleet_segments(specs: List[Tuple], shard_leaves: Tuple, shard_idx: Tuple, n_shards: int,
                         block: int) -> Tensor:
    """The packed byte buffer: leaf-major then shard, a quantised leaf as its
    shards' q8 code segments followed by their scale segments. One
    concatenation whatever the codecs."""
    segs = []
    for ki, (_k, _shape, _dt, _rb, codec) in enumerate(specs):
        if codec is None:
            for s in range(n_shards):
                segs.append(_to_wire_bytes(shard_leaves[s][ki].index_select(0, shard_idx[s])))
        else:
            scale_segs = []
            for s in range(n_shards):
                q, scale = quant.encode_q8(shard_leaves[s][ki].index_select(0, shard_idx[s]), block=block)
                segs.append(q.reshape(-1).view(torch.uint8))
                scale_segs.append(scale.reshape(-1).view(torch.uint8))
            segs.extend(scale_segs)
    return segs[0] if len(segs) == 1 else torch.cat(segs)


def _unpack_fleet_segments(packed: Tensor, specs: List[Tuple], n_shards: int, m: int, block: int) -> List[Tensor]:
    """Per leaf, the ``(n_shards * m,) + shape`` rows of the packed buffer."""
    leaves_rows = []
    off = 0
    for _k, shape, dt, row_bytes, codec in specs:
        if codec is None:
            size = n_shards * m * row_bytes
            leaves_rows.append(_from_wire_bytes(packed[off: off + size], (n_shards * m,) + shape, dt))
            off += size
        else:
            count = int(np.prod(shape, dtype=np.int64)) * m
            nb = -(-count // block)
            qsize = n_shards * nb * block
            q = _from_wire_bytes(packed[off: off + qsize], (n_shards * nb, block), torch.int8)
            off += qsize
            ssize = n_shards * nb * 4
            scales = _from_wire_bytes(packed[off: off + ssize], (n_shards * nb,), torch.float32)
            off += ssize
            vals = (q.to(torch.float32) * scales[:, None]).reshape(n_shards, nb * block)[:, :count]
            leaves_rows.append(vals.reshape((n_shards * m,) + shape).to(dt))
    return leaves_rows


def build_fleet_read(template: Any, names: List[str], n_shards: int, m: int) -> Callable:
    """A fleet read: ``fleet_read(shard_leaves, shard_idx)`` gathers ``m``
    session rows from each of ``n_shards`` stacked services (``shard_leaves``
    a tuple a shard of its leaf buffers in ``names`` order, ``shard_idx`` a
    tuple of ``(m,)`` int64 row indices; pad lanes read a scratch row and
    the caller drops them), crosses them as one packed byte buffer and
    returns ``pure_compute`` of every row, stacked, row ``shard * m + lane``.
    Under ``sync_precision`` eligible float leaves cross as q8 codes and
    scales in the same buffer."""
    from metrics_tpu_torch.serve import _stack_values

    specs = _leaf_wire_specs(template, names, m=m)
    block = quant.default_block()

    def fleet_read(shard_leaves: Tuple, shard_idx: Tuple) -> Any:
        packed = _pack_fleet_segments(specs, shard_leaves, shard_idx, n_shards, block)
        rows = _unpack_fleet_segments(packed, specs, n_shards, m, block)
        return _stack_values([template.pure_compute({k: r[i] for k, r in zip(names, rows)})
                              for i in range(n_shards * m)])

    return fleet_read


def build_fleet_rollup(template: Any, names: List[str], n_shards: int, m: int) -> Callable:
    """A fleet-wide roll-up: the packed gather of :func:`build_fleet_read`,
    then one fold of the ``n_shards * m`` rows into one state and ONE
    ``pure_compute``. ``fleet_rollup(shard_leaves, shard_idx, valid)`` takes
    the ``(n_shards * m,)`` bool mask of live rows in packed order: a row
    where it is False adds exactly nothing. The fold is the windows'
    (:func:`metrics_tpu_torch.streaming.window.fold_rows`): one masked
    reduction a leaf where every leaf is an integer sum, max or min, else the
    JAX package's left fold of ``pure_merge`` in packed order, step for step."""
    from metrics_tpu_torch.streaming.window import fold_rows

    specs = _leaf_wire_specs(template, names, m=m)
    block = quant.default_block()
    defaults = template.default_state()

    def fleet_rollup(shard_leaves: Tuple, shard_idx: Tuple, valid: Tensor) -> Any:
        packed = _pack_fleet_segments(specs, shard_leaves, shard_idx, n_shards, block)
        rows = dict(zip(names, _unpack_fleet_segments(packed, specs, n_shards, m, block)))
        acc = {k: defaults[k].to(valid.device).clone() for k in names}
        acc, _ = fold_rows(template, (acc, torch.zeros((), dtype=torch.int32, device=valid.device)), rows, valid)
        return template.pure_compute(acc)

    return fleet_rollup
