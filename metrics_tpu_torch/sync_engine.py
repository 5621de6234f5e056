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

Not ported here: the fleet reads (``metrics_tpu/sync_engine.py:613-811``,
with the serving fabric, ROADMAP.md Queue A item 11, part two).
"""
import os
import time
from typing import Any, Dict, Hashable, List, NamedTuple, Optional, Tuple

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
