"""The port's fleet reads (metrics_tpu_torch/sync_engine.py, fabric.py) against the JAX package's.

The byte wire: each leaf crosses as its raw bytes (``Tensor.view(torch.uint8)``,
bool as one byte), so ``_to_wire_bytes``/``_from_wire_bytes`` round-trip
every dtype exactly and the packed buffer of a fleet read is the JAX
package's byte for byte; under ``sync_precision="int8"`` a float leaf's q8
codes and scales are the JAX codec's. ``build_fleet_read`` and
``build_fleet_rollup`` give the JAX package's values on the same stacked
rows (counts exactly, floats to rtol 1e-6); a roll-up's pad lanes add
nothing, on the masked reduction (integer sums) and on the left fold (float
states). Through the fabric: one program a signature (its ``compile`` span
of kind ``fleet-read`` once), the ``collective:packed-read`` span's bytes
equal the JAX fabric's, the program cache is dropped on every failover and
membership change, and a program that fails degrades to the per-shard
fan-out with a ``fleet-read`` degrade, serving the same values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu_torch
from metrics_tpu import sync_engine as jsync
from metrics_tpu_torch import resilience, sync_engine
from tests.test_torch_fabric import FabPair, close, instrumented, span_counts, stream, values_close

DTYPES = [np.float32, np.int32, np.int64, np.uint8, np.int8, np.float64, np.bool_, np.int16, np.float16]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_wire_bytes_round_trip_exactly_and_match_the_jax_bitcast(dtype):
    rng = np.random.RandomState(0)
    x = (rng.rand(5, 3, 2) * 200 - 100).astype(dtype)
    if dtype is np.float32:
        x.reshape(-1)[:4] = [np.nan, -0.0, np.inf, -np.inf]
    t = torch.from_numpy(x)
    wire = sync_engine._to_wire_bytes(t)
    assert wire.dtype == torch.uint8 and wire.ndim == 1
    if dtype not in (np.int64, np.float64):  # 64-bit leaves: the JAX package runs without x64
        np.testing.assert_array_equal(wire.numpy(), np.asarray(jsync._to_wire_bytes(jnp.asarray(x))).reshape(-1))
    back = sync_engine._from_wire_bytes(wire, x.shape, t.dtype)
    assert back.dtype == t.dtype and back.numpy().tobytes() == x.tobytes()
    # a segment that starts off the dtype's alignment inside a packed buffer
    packed = torch.cat([torch.zeros(1, dtype=torch.uint8), wire])
    assert sync_engine._from_wire_bytes(packed[1:], x.shape, t.dtype).numpy().tobytes() == x.tobytes()


@pytest.mark.parametrize("template,m", [("acc8", 8), ("macro8", 16), ("mean", 8), ("countmin", 8),
                                        ("countmin_int8", 8), ("countmin_int8", 64)])
def test_leaf_wire_specs_sig_and_bytes_match_the_jax_package(template, m):
    make_t, make_j = TEMPLATES_WIRE[template]
    t, j = make_t(), make_j()
    names = list(t.default_state())
    specs, jspecs = sync_engine._leaf_wire_specs(t, names, m=m), jsync._leaf_wire_specs(j, names, m=m)
    assert [(k, sh, rb, c is None) for k, sh, _, rb, c in specs] == [(k, sh, rb, c is None) for k, sh, _, rb, c in jspecs]
    assert sync_engine.fleet_wire_sig(specs) == jsync.fleet_wire_sig(jspecs)
    for n in (1, 3):
        assert sync_engine.fleet_wire_nbytes(specs, n, m) == jsync.fleet_wire_nbytes(jspecs, n, m)


def test_the_kill_switch_and_an_opted_out_leaf_cross_at_full_precision(monkeypatch):
    t = TEMPLATES_WIRE["countmin_int8"][0]()
    assert sync_engine._leaf_wire_specs(t, ["value"], m=64)[0][4] is not None
    assert sync_engine._leaf_wire_specs(t, ["value"], m=None)[0][4] is None
    t._quantize["value"] = False
    assert sync_engine._leaf_wire_specs(t, ["value"], m=64)[0][4] is None
    monkeypatch.setenv("METRICS_TPU_QUANT_SYNC", "0")
    assert sync_engine._leaf_wire_specs(TEMPLATES_WIRE["countmin_int8"][0](), ["value"], m=64)[0][4] is None


TEMPLATES_WIRE = {
    "acc8": (lambda: metrics_tpu_torch.Accuracy(task="multiclass", num_classes=8, device="cpu"),
             lambda: metrics_tpu.Accuracy(task="multiclass", num_classes=8)),
    "macro8": (lambda: metrics_tpu_torch.Accuracy(num_classes=8, average="macro", device="cpu"),
               lambda: metrics_tpu.Accuracy(num_classes=8, average="macro")),
    "mean": (lambda: metrics_tpu_torch.MeanMetric(device="cpu"), lambda: metrics_tpu.MeanMetric()),
    "countmin": (lambda: metrics_tpu_torch.CountMinHeavyHitters(depth=4, width=64, device="cpu"),
                 lambda: metrics_tpu.CountMinHeavyHitters(depth=4, width=64)),
    "countmin_int8": (lambda: metrics_tpu_torch.CountMinHeavyHitters(depth=4, width=64, sync_precision="int8",
                                                                     device="cpu"),
                      lambda: metrics_tpu.CountMinHeavyHitters(depth=4, width=64, sync_precision="int8")),
}


def _stacked_rows(template, n_shards, capacity, seed):
    """Random per-shard stacked states of ``template``'s leaves (capacity + 1 rows: the scratch row last), as numpy."""
    rng = np.random.RandomState(seed)
    defaults = TEMPLATES_WIRE[template][0]().default_state()
    shards = []
    for _ in range(n_shards):
        leaves = []
        for k, d in defaults.items():
            shape = (capacity + 1,) + tuple(d.shape)
            if d.is_floating_point():
                arr = (rng.rand(*shape) * 50).astype(np.float32)
            else:
                arr = rng.randint(0, 40, shape).astype(np.int32)
            leaves.append(arr)
        shards.append(leaves)
    return list(defaults), shards


@pytest.mark.parametrize("template", ["acc8", "macro8", "mean", "countmin", "countmin_int8"])
def test_build_fleet_read_and_rollup_equal_the_jax_programs(template):
    n, m, capacity = 3, 8, 12
    names, shards = _stacked_rows(template, n, capacity, seed=1)
    t_tmpl, j_tmpl = _primed(template)
    rng = np.random.RandomState(2)
    live = [4, 8, 2]
    idx = []
    for k in live:  # the live lanes' rows, then pad lanes at the scratch row
        i = np.full((m,), capacity, np.int64)
        i[:k] = rng.choice(capacity, k, replace=False)
        idx.append(i)
    valid = np.zeros((n * m,), bool)
    for s, k in enumerate(live):
        valid[s * m: s * m + k] = True
    t_leaves = tuple(tuple(torch.from_numpy(a) for a in leaves) for leaves in shards)
    # the JAX program gathers from (capacity, ...) stacks and clamps the pad index onto the last row
    j_leaves = tuple(tuple(jnp.asarray(a[:capacity]) for a in leaves) for leaves in shards)
    t_idx = tuple(torch.from_numpy(i) for i in idx)
    j_idx = tuple(jnp.asarray(i.astype(np.int32)) for i in idx)
    got = sync_engine.build_fleet_read(t_tmpl, names, n, m)(t_leaves, t_idx)
    want = jsync.build_fleet_read(j_tmpl, names, n, m)(j_leaves, j_idx)
    for s, k in enumerate(live):
        for lane in range(k):
            close(_lane(got, s * m + lane), np.asarray(want)[s * m + lane] if not isinstance(want, dict) else
                  {kk: v[s * m + lane] for kk, v in want.items()})
    got_r = sync_engine.build_fleet_rollup(t_tmpl, names, n, m)(t_leaves, t_idx, torch.from_numpy(valid))
    want_r = jsync.build_fleet_rollup(j_tmpl, names, n, m)(j_leaves, j_idx, jnp.asarray(valid))
    close(got_r, want_r)
    # pad lanes add nothing: the roll-up of the live rows alone, by a host fold of the unpacked rows
    specs = sync_engine._leaf_wire_specs(t_tmpl, names, m=m)
    block = metrics_tpu_torch.quant.default_block()
    rows = sync_engine._unpack_fleet_segments(
        sync_engine._pack_fleet_segments(specs, t_leaves, t_idx, n, block), specs, n, m, block)
    acc = {k: v.clone() for k, v in t_tmpl.default_state().items()}
    seen = 0
    for r in np.flatnonzero(valid):
        seen += 1
        acc = t_tmpl.pure_merge(acc, {k: x[r] for k, x in zip(names, rows)}, count=torch.tensor(float(seen)))
    close(got_r, t_tmpl.pure_compute(acc))


def _primed(template):
    """Both packages' templates after one update: a template's mode is set by its first input, as in a service."""
    make_t, make_j = TEMPLATES_WIRE[template]
    t, j = make_t(), make_j()
    if template.startswith(("acc", "macro")):
        x = np.arange(8) % 8
        t.update(torch.from_numpy(x), torch.from_numpy(x))
        j.update(jnp.asarray(x), jnp.asarray(x))
    return t, j


def _lane(vals, i):
    from metrics_tpu_torch.serve import _lane_value

    return _lane_value(vals, i)


def test_packed_buffer_is_the_jax_packages_byte_for_byte():
    names, shards = _stacked_rows("macro8", 2, 10, seed=3)
    idx = [np.array([0, 3, 10, 10], np.int64), np.array([9, 1, 2, 10], np.int64)]
    t_leaves = tuple(tuple(torch.from_numpy(a) for a in leaves) for leaves in shards)
    j_leaves = tuple(tuple(jnp.asarray(a) for a in leaves) for leaves in shards)
    t_tmpl, j_tmpl = _primed("macro8")
    specs, jspecs = sync_engine._leaf_wire_specs(t_tmpl, names, m=4), jsync._leaf_wire_specs(j_tmpl, names, m=4)
    got = sync_engine._pack_fleet_segments(specs, t_leaves, tuple(torch.from_numpy(i) for i in idx), 2, 256)
    want = jsync._pack_fleet_segments(jspecs, j_leaves, tuple(jnp.asarray(i.astype(np.int32)) for i in idx), 2, 256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numel() == sync_engine.fleet_wire_nbytes(specs, 2, 4)


# ------------------------------------------------------------ through the fabric
@pytest.mark.parametrize("template", ["acc8", "macro8", "countmin"])
def test_fabric_compute_all_and_rollup_equal_the_jax_fabric(template):
    pair = FabPair(num_shards=3, template=template)
    rng = np.random.RandomState(4)
    for i in range(30):
        if template == "countmin":
            pair.submit(f"t{i % 10}", rng.randint(0, 30, 20).astype(np.float32))
        else:
            pair.submit(f"t{i % 10}", rng.randint(0, 8, 16), rng.randint(0, 8, 16))
    pair.both("drain")
    out = {}
    ts, js = instrumented(lambda: out.update(zip(("t", "j"), pair.both("compute_all"))))
    values_close(out["t"], out["j"])
    assert span_counts(ts) == span_counts(js)
    (coll,), (jcoll,) = ts.spans(name="collective", kind="packed-read"), js.spans(name="collective", kind="packed-read")
    for key in ("nbytes", "logical_nbytes", "quantized", "nleaves", "shards"):
        assert coll.attrs[key] == jcoll.attrs[key], key
    got, want = pair.both("rollup")
    close(got, want)
    got, want = pair.both("rollup", ["t1", "t4", "t7"])
    close(got, want)
    assert pair.t.stats == pair.j.stats
    pair.shutdown()


def test_one_program_a_signature_and_memo_served_rereads():
    pair = FabPair(num_shards=2)
    _, ops = stream(n_sessions=6, ops=2)
    pair.feed(ops)
    ts, js = instrumented(lambda: (pair.both("compute_all"), pair.both("compute_all")))
    assert len(ts.spans(name="compile", kind="fleet-read")) == len(js.spans(name="compile", kind="fleet-read")) == 1
    reads = [e.attrs for e in ts.spans(name="read", kind="fleet")]
    assert [r["dirty"] for r in reads] == [6, 0] and reads[1]["memoized"] == 6
    pair.feed(ops[:2])  # two sessions dirty again: the same signature, no new program
    ts, js = instrumented(lambda: pair.both("compute_all"))
    assert not ts.spans(name="compile") and span_counts(ts) == span_counts(js)
    assert len(pair.t._fleet_programs) == 1
    pair.shutdown()


def test_a_capacity_doubling_drops_the_programs_of_the_old_leaves():
    pair = FabPair(num_shards=2)
    _, ops = stream(n_sessions=8, ops=1)
    pair.feed(ops)
    pair.both("compute_all")
    pair.both("rollup")
    assert len(pair.t._fleet_programs) == 2
    old = set(pair.t._fleet_programs)
    _, more = stream(n_sessions=200, ops=1, seed=1)  # past 64 rows a shard: every shard's buffers double
    pair.feed(more)
    ts, js = instrumented(lambda: pair.both("compute_all"))
    assert span_counts(ts) == span_counts(js)
    assert len(pair.t._fleet_programs) == 1 and not old & set(pair.t._fleet_programs)
    got, want = pair.both("rollup")
    close(got, want)
    assert len(pair.t._fleet_programs) == 2 and not old & set(pair.t._fleet_programs)
    pair.check()
    pair.shutdown()


def test_failover_and_membership_drop_the_fleet_programs(tmp_path):
    pair = FabPair(tmp_path, num_shards=2)
    _, ops = stream(n_sessions=8)
    pair.feed(ops)
    pair.both("compute_all")
    pair.both("rollup")
    assert len(pair.t._fleet_programs) == 2
    pair.both("kill_shard", 0)
    pair.both("fail_over", 0)
    assert pair.t._fleet_programs == {}
    pair.feed(ops[:3])
    pair.check()
    assert pair.t._fleet_programs
    pair.both("add_shard")
    assert pair.t._fleet_programs == {}
    pair.both("compute_all")
    pair.both("rebalance")
    assert pair.t._fleet_programs == {}
    pair.check()
    pair.both("remove_shard", 2)
    assert pair.t._fleet_programs == {}
    pair.check()
    pair.shutdown()


def test_a_failed_fleet_program_degrades_to_the_per_shard_fan_out(monkeypatch):
    pair = FabPair(num_shards=3)
    _, ops = stream(n_sessions=9)
    pair.feed(ops)
    want, _ = pair.both("compute_all")
    pair.feed(ops)

    def broken(*args, **kwargs):
        raise RuntimeError("a value-dependent compute")

    monkeypatch.setattr(sync_engine, "build_fleet_read", broken)
    pair.t._drop_fleet_programs()
    before = resilience.degrades().get("fleet-read", 0)
    with metrics_tpu_torch.telemetry.instrument() as ts:
        got = pair.t.compute_all()
    assert resilience.degrades()["fleet-read"] == before + 1
    (deg,) = ts.spans(name="degrade", kind="fleet-read")
    assert deg.attrs["cause"] == "RuntimeError"
    jgot = pair.j.compute_all()
    values_close(got, jgot)
    assert sorted(got) == sorted(want) and pair.t._fleet_programs == {}
    pair.shutdown()


def test_quantized_fleet_read_stays_within_the_codec_bound():
    pair = FabPair(num_shards=2, template="countmin")
    pair.t = type(pair.t)(TEMPLATES_WIRE["countmin_int8"][0](), num_shards=2)
    pair.j = type(pair.j)(TEMPLATES_WIRE["countmin_int8"][1](), num_shards=2)
    rng = np.random.RandomState(6)
    for i in range(40):
        pair.submit(f"a{i % 16}", rng.randint(0, 500, 64).astype(np.float32))
    pair.both("drain")
    with metrics_tpu_torch.telemetry.instrument() as ts:
        got = pair.t.compute_all()
    jgot = pair.j.compute_all()
    (coll,) = ts.spans(name="collective", kind="packed-read")
    assert coll.attrs["quantized"] and coll.attrs["nbytes"] < coll.attrs["logical_nbytes"]
    services = {s.shard_id: s.service for s in pair.t._shards}
    for name, val in got.items():
        svc = services[pair.t.shard_for(name)]
        table = svc._stacked["value"][svc._rows[name]]
        # each of row 0's cells within half a q8 step of its block's scale (amax / 127)
        bound = table.shape[1] * float(table.abs().max()) / 254 * (1 + 1e-6)
        assert abs(float(val) - float(table[0].sum())) <= bound
        close(val, jgot[name])
    pair.shutdown()


def test_rollup_computes_with_a_shard_that_served_where_jax_raises(tmp_path):
    """A reference fault not copied (ROADMAP Queue C): the JAX roll-up computes
    with shard 0's template, whose mode an ``Accuracy`` only learns from an
    input, so with no session on shard 0 it raises; the port's computes with a
    shard that served and equals the dedicated metric's value."""
    pair = FabPair(num_shards=4, template="macro8")
    name = next(f"m{i}" for i in range(1000) if pair.t.shard_for(f"m{i}") != 0)
    rng = np.random.RandomState(8)
    p, t = rng.rand(32, 8).astype(np.float32), rng.randint(0, 8, 32)
    pair.submit(name, p, t)
    got = pair.t.rollup()
    with pytest.raises(RuntimeError, match="determined mode"):
        pair.j.rollup()
    ref = metrics_tpu_torch.Accuracy(num_classes=8, average="macro", device="cpu")
    ref.update(torch.from_numpy(p), torch.from_numpy(t))
    assert torch.equal(got, ref.compute())
    close(got, pair.j.compute(name))
    pair.shutdown()
