"""The port's span stream held against the JAX package's on the CPU.

The same numpy inputs, made from a seed, go through both packages in one
process, each inside its own ``telemetry.instrument()``. For every case the
multiset of ``(name, owner, kind)`` events and the session's
``retrace_causes()`` must be equal, and so must the always-on counters
(``snapshot()``, cleared before the case), but for the port's own
``update:rows``, ``update:bucket_rows``, ``format:labels`` and
``format:onehot``. Both sessions' JSON-lines exports
are read back by ``tools/trace_report.py`` (``load_events``/``summarize``)
and their launch and retrace sections must be equal once the µs columns are
stripped. Counts, keys, causes and integer bytes are exact; no µs value is
compared.

One difference is pinned rather than hidden: where an engine declines a
``jit_update`` call, the JAX package serves it with ``jax.jit``, whose first
call compiles (a ``compile`` span of kind ``jit``), while the port serves it
eagerly and builds nothing (:func:`test_a_cold_degrade_differs_only_by_the_jax_jit_compile`).
"""
import collections
import contextlib
import importlib.util
import json
import statistics
import sys
import threading
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu_torch
from metrics_tpu import faults as jax_faults
from metrics_tpu import profiling as jax_profiling
from metrics_tpu import telemetry as jax_telemetry
from metrics_tpu.metric import Metric as JaxMetric
from metrics_tpu.parallel.dist_env import NoOpEnv as JaxNoOp
import metrics_tpu.streaming as jax_streaming
from metrics_tpu.streaming.sketch import HostQuantileSketch as JaxHostQuantileSketch
from metrics_tpu_torch import Metric, faults, profiling, streaming, telemetry
from metrics_tpu_torch.analysis import cost_model
from metrics_tpu_torch.ops import marks
from metrics_tpu_torch.parallel import NoOpEnv
from metrics_tpu_torch.streaming import HostQuantileSketch

REPO = Path(__file__).resolve().parent.parent
C = 5
COLLECTION = ("Accuracy", "Precision", "Recall", "F1Score", "ConfusionMatrix")


def _trace_report():
    spec = importlib.util.spec_from_file_location("trace_report", REPO / "tools" / "trace_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_flag_sum():
    class FlagSum(JaxMetric):  # owners are class names: both packages' metric is called FlagSum
        full_state_update = False

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("total", jnp.asarray(0.0), dist_reduce_fx="sum")

        def update(self, values, negate=False):
            self.total = self.total + (-1.0 if negate else 1.0) * jnp.sum(values)

        def compute(self):
            return self.total

    return FlagSum


def _flag_sum():
    class FlagSum(Metric):
        full_state_update = False

        def __init__(self, **kwargs):
            super().__init__(device="cpu", **kwargs)
            self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

        def update(self, values, negate=False):
            self.total = self.total + (-1.0 if negate else 1.0) * torch.sum(values)

        def compute(self):
            return self.total

    return FlagSum


_JaxFlagSum, _FlagSum = _jax_flag_sum(), _flag_sum()


class _JaxFake2(JaxNoOp):
    def world_size(self):
        return 2

    def all_gather(self, x):
        return [x, x]


class _TorchFake2(NoOpEnv):
    def world_size(self):
        return 2

    def all_gather(self, x):
        return [x, x]


def _scores(rng, rows):
    return rng.rand(rows, C).astype(np.float32), rng.randint(0, C, rows).astype(np.int32)


def _jax(x):
    return jnp.asarray(x)


def _torch(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------------ the cases
# each case runs the same calls on the same numpy inputs in either package, given (package, to-array, device kw)
def _engine_batches(pkg, arr, dev):
    rng = np.random.RandomState(0)
    m = pkg.Accuracy(num_classes=C, jit_update=True, **dev)
    for rows in (8, 8, 13, 16, 3):  # the first build, a hit, a new shape bucket
        p, t = _scores(rng, rows)
        m.update(arr(p), arr(t))


def _new_dtype(pkg, arr, dev):
    rng = np.random.RandomState(1)
    m = pkg.Accuracy(num_classes=C, jit_update=True, **dev)
    p, t = _scores(rng, 8)
    m.update(arr(p), arr(t))
    m.update(arr(p.astype(np.float16)), arr(t))


def _new_static_key(pkg, arr, dev):
    rng = np.random.RandomState(2)
    m = (_JaxFlagSum if pkg is metrics_tpu else _FlagSum)(jit_update=True)
    for negate in (False, True, False):
        m.update(arr(rng.rand(6).astype(np.float32)), negate=negate)


def _collection(pkg, dev, fused):
    return pkg.MetricCollection([getattr(pkg, n)(num_classes=C, **dev) for n in COLLECTION], fused_update=fused)


def _collection_case(fused):
    def run(pkg, arr, dev):
        rng = np.random.RandomState(3)
        mc = _collection(pkg, dev, fused)
        for _ in range(3):
            p, t = _scores(rng, 8)
            mc.update(arr(p), arr(t))
        mc.compute()
        p, t = _scores(rng, 8)
        mc(arr(p), arr(t))
        mc.reset()
        mc.update(arr(p), arr(t))
        mc.compute()

    return run


def _compute_reset_cycles(pkg, arr, dev):
    rng = np.random.RandomState(4)
    m = pkg.Accuracy(num_classes=C, **dev)
    for _ in range(3):
        p, t = _scores(rng, 8)
        m.update(arr(p), arr(t))
        m.compute()
        m.compute()  # memoised: no span
        m.reset()


def _streaming(pkg):
    return jax_streaming if pkg is metrics_tpu else streaming


def _window(pkg, arr, dev):
    w = _streaming(pkg).SlidingWindow(pkg.SumMetric(**dev), window=3, jit_update=False)
    for i in range(5):
        w.update(arr(np.float32(i)))
        if i % 2:
            w.compute()


def _other_windows(pkg, arr, dev):
    s = _streaming(pkg)
    windows = [s.TumblingWindow(pkg.SumMetric(**dev), window=2, jit_update=False),
               s.ExponentialDecay(pkg.MeanMetric(**dev), halflife=2.0, jit_update=False),
               s.ResolutionLadder(pkg.SumMetric(**dev), levels=(2, 3), jit_update=False),
               s.FoldTreeWindow(pkg.SumMetric(**dev), window=4, jit_update=False)]
    for i in range(7):
        for w in windows:
            w.update(arr(np.float32(i)))
    for w in windows:
        w.compute()
    windows[2].compute_level(1)
    windows[3].compute_range(0, 3)


def _sketch(pkg, arr, dev):
    s = _streaming(pkg)
    x = arr(np.random.RandomState(5).rand(16).astype(np.float32))
    for sketch in (s.QuantileSketch(**dev), s.HyperLogLog(precision=8, **dev),
                   s.CountMinHeavyHitters(depth=2, width=64, **dev)):
        sketch.update(x)
        sketch.compute()


def _warm_degrade(pkg, arr, dev):
    inject = jax_faults.inject if pkg is metrics_tpu else faults.inject
    rng = np.random.RandomState(6)
    p, t = _scores(rng, 8)
    m = pkg.Accuracy(num_classes=C, jit_update=True, **dev)
    m.update(arr(p), arr(t))
    # a first degrade outside the session warms the JAX package's jax.jit fallback (see the cold case below)
    with inject("launch", count=1):
        m.update(arr(p), arr(t))
    for _ in range(4):  # the cooldown
        m.update(arr(p), arr(t))
    return m, inject, (arr(p), arr(t))


def _sync(pkg, arr, dev):
    env = _JaxFake2() if pkg is metrics_tpu else _TorchFake2()
    rng = np.random.RandomState(7)
    mc = pkg.MetricCollection([getattr(pkg, n)(num_classes=C, sync_env=env, **dev) for n in COLLECTION[:3]])
    for _ in range(2):
        p, t = _scores(rng, 8)
        mc.update(arr(p), arr(t))
    mc.compute()
    return mc


CASES = {
    "engine_batch_sizes": _engine_batches,
    "new_dtype": _new_dtype,
    "new_static_key": _new_static_key,
    "collection_eager": _collection_case(False),
    "collection_fused": _collection_case(True),
    "compute_reset_cycles": _compute_reset_cycles,
    "sliding_window": _window,
    "other_windows": _other_windows,
    "sketches": _sketch,
    "sync": _sync,
}


def _multiset(session):
    return collections.Counter((e.name, e.owner, e.kind) for e in session.events)


def _both(run):
    """``run`` in each package inside its own session, counters cleared first."""
    jax_telemetry.reset_counters()
    telemetry.reset_counters()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with jax_telemetry.instrument() as jax_session:
            run(metrics_tpu, _jax, {})
        with telemetry.instrument() as session:
            run(metrics_tpu_torch, _torch, {"device": "cpu"})
    return jax_session, session


@pytest.mark.parametrize("case", sorted(CASES))
def test_event_stream_equals_jax(case):
    jax_session, session = _both(CASES[case])
    assert len(session.events) > 0
    assert _multiset(session) == _multiset(jax_session)
    assert session.retrace_causes() == jax_session.retrace_causes()


# the port's own counters, summed from its engine spans' rows and bucket, and its members' formatting routes:
# the JAX package has none
PORT_COUNTERS = ("update:rows", "update:bucket_rows", "format:labels", "format:onehot")


def _jax_counters(counters):
    return {k: v for k, v in counters.items() if k not in PORT_COUNTERS}


@pytest.mark.parametrize("case", sorted(CASES))
def test_counters_equal_jax(case):
    _both(CASES[case])
    jax_counts, counts = jax_telemetry.snapshot(), telemetry.snapshot()
    assert _jax_counters(counts) == jax_counts
    assert counts.get("collective:bytes", 0) == jax_counts.get("collective:bytes", 0)


def test_warm_degrade_stream_and_counters_equal_jax():
    jm, jax_inject, jax_args = _warm_degrade(metrics_tpu, _jax, {})
    tm, inject, args = _warm_degrade(metrics_tpu_torch, _torch, {"device": "cpu"})
    jax_telemetry.reset_counters()
    telemetry.reset_counters()
    with jax_telemetry.instrument() as jax_session, jax_inject("launch", count=1):
        jm.update(*jax_args)
    with telemetry.instrument() as session, inject("launch", count=1):
        tm.update(*args)
    assert _multiset(session) == _multiset(jax_session) == collections.Counter(
        {("degrade", "Accuracy", "dispatch"): 1, ("update", "Accuracy", "jit"): 1})
    assert session.retrace_causes() == jax_session.retrace_causes() == {}
    assert _jax_counters(telemetry.snapshot()) == jax_telemetry.snapshot()
    (span,) = session.spans(name="degrade")
    (jax_span,) = jax_session.spans(name="degrade")
    for key in ("cause", "cooldown", "permanent", "failures"):
        assert span.attrs[key] == jax_span.attrs[key], key
    assert span.attrs["cause"] == "injected:launch" and span.attrs["cooldown"] == 8


def test_a_cold_degrade_differs_only_by_the_jax_jit_compile():
    rng = np.random.RandomState(8)
    p, t = _scores(rng, 8)
    jm, tm = metrics_tpu.Accuracy(num_classes=C, jit_update=True), metrics_tpu_torch.Accuracy(
        num_classes=C, jit_update=True, device="cpu")
    jm.update(_jax(p), _jax(t))
    tm.update(_torch(p), _torch(t))
    with jax_telemetry.instrument() as jax_session, jax_faults.inject("launch", count=1):
        jm.update(_jax(p), _jax(t))
    with telemetry.instrument() as session, faults.inject("launch", count=1):
        tm.update(_torch(p), _torch(t))
    jax_events = _multiset(jax_session)
    assert jax_events.pop(("compile", "Accuracy", "jit")) == 1  # jax.jit's first call; the port builds nothing
    assert _multiset(session) == jax_events
    assert jax_session.retrace_causes() == {"first-compile": 1} and session.retrace_causes() == {}
    np.testing.assert_array_equal(tm.tp.numpy(), np.asarray(jm.tp))


def test_forward_degrade_stream_equals_jax():
    rng = np.random.RandomState(9)
    p, t = _scores(rng, 8)
    jm, tm = metrics_tpu.Accuracy(num_classes=C, jit_update=True), metrics_tpu_torch.Accuracy(
        num_classes=C, jit_update=True, device="cpu")
    with jax_telemetry.instrument() as jax_session, jax_faults.inject("launch", count=1):
        jax_value = jm(_jax(p), _jax(t))
    with telemetry.instrument() as session, faults.inject("launch", count=1):
        value = tm(_torch(p), _torch(t))
    assert _multiset(session) == _multiset(jax_session)
    assert session.retrace_causes() == jax_session.retrace_causes()
    assert float(value) == float(jax_value)


def test_sync_collective_spans_equal_sync_stats_and_jax():
    jax_session, session = _both(_sync)
    for s in (jax_session, session):
        assert s.count(name="sync", kind="collection") == 1
    spans = session.spans(name="collective")
    assert [(e.kind, e.attrs["nbytes"]) for e in spans] == [
        (e.kind, e.attrs["nbytes"]) for e in jax_session.spans(name="collective")]
    assert session.collective_bytes() == jax_session.collective_bytes() > 0


# ------------------------------------------------------------------ exports
def _launch_and_retrace_sections(summary):
    """The span table's (span, count) rows and the retrace lines of a
    ``trace_report.summarize`` output, µs columns stripped."""
    lines = summary.splitlines()
    table = lines.index(next(line for line in lines if line.startswith("span")))
    rows = []
    for line in lines[table + 1:]:
        if not line.strip():
            break
        rows.append(tuple(line.split()[:2]))
    start = lines.index(next(line for line in lines if line.startswith("retraces:")))
    retraces = []
    for line in lines[start:]:
        if not line.strip():
            break
        retraces.append(line)
    return rows, retraces


@pytest.mark.parametrize("case", ["engine_batch_sizes", "collection_fused", "sliding_window", "sync"])
def test_both_jsonl_exports_summarise_alike_in_trace_report(case, tmp_path):
    report = _trace_report()
    jax_session, session = _both(CASES[case])
    jax_session.export_jsonl(str(tmp_path / "jax.jsonl"))
    session.export_jsonl(str(tmp_path / "port.jsonl"))
    jax_events = report.load_events(str(tmp_path / "jax.jsonl"))
    events = report.load_events(str(tmp_path / "port.jsonl"))
    assert len(events) == len(session.events) and {"name", "owner", "kind", "ts_us", "dur_us", "tid", "attrs"} <= set(
        events[0])
    assert _launch_and_retrace_sections(report.summarize(events)) == _launch_and_retrace_sections(
        report.summarize(jax_events))


def test_chrome_trace_export_loads_with_its_records(tmp_path):
    rng = np.random.RandomState(10)
    with telemetry.instrument() as session:
        m = metrics_tpu_torch.Accuracy(num_classes=C, jit_update=True, device="cpu")
        for _ in range(3):
            m.update(*map(_torch, _scores(rng, 8)))
        m.compute()
        m.reset()
    path = tmp_path / "trace.json"
    session.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())["traceEvents"]
    phases = collections.Counter(r["ph"] for r in trace)
    assert phases["X"] + phases["i"] == len(session.events) and phases["i"] == 1  # the reset instant
    assert phases["M"] == 2  # the process and its one thread lane
    assert {r["name"] for r in trace if r["ph"] == "X"} >= {"Accuracy.update [aot]", "Accuracy.compile [aot]"}


# ------------------------------------------------------------------ trackers, switches, sessions
def test_trackers_count_what_the_jax_trackers_count():
    rng = np.random.RandomState(11)
    data = [_scores(rng, 8) for _ in range(3)]
    counts = []
    for pkg, prof, arr, dev in ((metrics_tpu, jax_profiling, _jax, {}),
                                (metrics_tpu_torch, profiling, _torch, {"device": "cpu"})):
        m = pkg.Accuracy(num_classes=C, jit_update=True, **dev)
        with prof.track_dispatches() as d, prof.track_forwards() as f:
            for p, t in data:
                m.update(arr(p), arr(t))
            m(arr(data[0][0]), arr(data[0][1]))
        env = _JaxFake2() if pkg is metrics_tpu else _TorchFake2()
        s_metric = pkg.SumMetric(sync_env=env, **dev)
        s_metric.update(arr(np.float32(2.0)))
        with prof.track_syncs() as s:
            s_metric.compute()
        counts.append((d.dispatches, d.retraces, d.dispatch_count(kind="aot"), f.launches, f.retraces,
                       s.collectives, s.buckets, s.bytes_on_wire, m.dispatch_stats["dispatches"]))
    assert counts[0] == counts[1]
    assert counts[1][0] == 3 and counts[1][3] == 1


def test_tracker_dispatches_equal_the_owners_dispatch_stats():
    rng = np.random.RandomState(12)
    members = [metrics_tpu_torch.Accuracy(num_classes=C, jit_update=True, device="cpu"),
               metrics_tpu_torch.ConfusionMatrix(num_classes=C, device="cpu")]
    with profiling.track_dispatches() as tracker, telemetry.instrument() as session:
        for _ in range(4):
            p, t = _scores(rng, 8)
            for m in members:
                m.update(_torch(p), _torch(t))
    assert tracker.dispatches == sum(m.dispatch_stats["dispatches"] for m in members) == session.count(name="update")
    assert tracker.retraces == members[0].dispatch_stats["retraces"] == session.count(name="compile")


@pytest.mark.parametrize("switch", ["0", "false", "off"])
def test_the_kill_switch_silences_stream_counters_and_trackers(monkeypatch, switch):
    monkeypatch.setenv("METRICS_TPU_TELEMETRY", switch)
    telemetry.reset_counters()
    rng = np.random.RandomState(13)
    with telemetry.instrument() as session, profiling.track_dispatches() as tracker:
        m = metrics_tpu_torch.Accuracy(num_classes=C, jit_update=True, device="cpu")
        m.update(*map(_torch, _scores(rng, 8)))
        m.compute()
    assert session.events == [] and telemetry.snapshot() == {} and tracker.dispatches == 0
    assert m.dispatch_stats["dispatches"] == 1 and not telemetry.subscribed() and telemetry.clock() is None


def test_the_timeline_switch_and_the_always_on_timeline(monkeypatch):
    telemetry.reset_timeline()
    rng = np.random.RandomState(14)
    m = metrics_tpu_torch.Accuracy(num_classes=C, jit_update=True, device="cpu")
    for _ in range(4):
        m.update(*map(_torch, _scores(rng, 8)))  # no subscriber
    timeline = telemetry.timeline()
    assert timeline["update"]["count"] == 4 and timeline["compile"]["count"] == 1
    assert timeline["update"]["p50_us"] > 0 and timeline["update"]["max_us"] >= timeline["update"]["p50_us"]
    assert telemetry.timeline(owner="@shard99") == {}
    monkeypatch.setenv("METRICS_TPU_TIMELINE", "0")
    telemetry.reset_timeline()
    m.update(*map(_torch, _scores(rng, 8)))
    assert telemetry.timeline() == {} and telemetry.clock() is None


def test_nested_sessions_each_see_every_event_inside():
    rng = np.random.RandomState(15)
    m = metrics_tpu_torch.Accuracy(num_classes=C, device="cpu")
    with telemetry.instrument() as outer:
        m.update(*map(_torch, _scores(rng, 8)))
        with telemetry.instrument() as inner:
            m.update(*map(_torch, _scores(rng, 8)))
            m.compute()
        m.reset()
    assert [e.name for e in inner.events] == ["update", "compute"]
    assert [e.name for e in outer.events] == ["update", "update", "compute", "reset"]
    assert outer.events[1:3] == inner.events


def test_emission_from_many_threads_loses_no_event():
    threads, per_thread = 8, 500
    telemetry.reset_counters()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        # all workers alive together, so no thread reuses another's ident
        start = threading.Barrier(threads)

        def work(i):
            start.wait(30)
            for _ in range(per_thread):
                telemetry.emit("update", f"T{i}", "eager", nbytes=1)

        with telemetry.instrument() as session:
            workers = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(30)
            assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert len(session.events) == threads * per_thread
    assert telemetry.snapshot()["update:eager"] == threads * per_thread
    assert len(set(telemetry.thread_names()) & {e.tid for e in session.events}) == threads


def test_attributes_hold_numbers_and_strings_only():
    rng = np.random.RandomState(16)
    with telemetry.instrument() as session:
        m = metrics_tpu_torch.Accuracy(num_classes=C, jit_update=True, device="cpu")
        for rows in (8, 13):
            m.update(*map(_torch, _scores(rng, rows)))
        m(*map(_torch, _scores(rng, 8)))
        _sync(metrics_tpu_torch, _torch, {"device": "cpu"})

    def plain(v):
        return v is None or isinstance(v, (bool, int, float, str)) or (
            isinstance(v, tuple) and all(plain(x) for x in v))

    for e in session.events:
        assert all(plain(v) for v in e.attrs.values()), (e.name, e.attrs)


def test_the_timeline_sketch_bins_equal_jax():
    rng = np.random.RandomState(18)
    values = np.concatenate([rng.lognormal(0, 6, 2000), -rng.lognormal(0, 6, 2000), [0.0, 1e-30, 1e30, 1.0, -1.0]])
    for bins, alpha in ((8, 0.2), (512, 0.05), (512, 0.01)):
        sketch, jax_sketch = HostQuantileSketch(bins=bins, alpha=alpha), JaxHostQuantileSketch(bins=bins, alpha=alpha)
        for v in values:
            assert sketch._index(float(v)) == jax_sketch._index(float(v)), (bins, alpha, v)
            sketch.add(float(v))
            jax_sketch.add(float(v))
        np.testing.assert_array_equal(sketch.counts, jax_sketch.counts)
        assert sketch.quantile(0.5) == jax_sketch.quantile(0.5)


def test_the_profiler_sees_the_engine_and_compute_ranges():
    rng = np.random.RandomState(19)
    m = metrics_tpu_torch.Accuracy(num_classes=C, jit_update=True, device="cpu")
    m.update(*map(_torch, _scores(rng, 8)))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        m.update(*map(_torch, _scores(rng, 8)))
        m(*map(_torch, _scores(rng, 8)))
        m.compute()
    names = {e.key for e in prof.key_averages()}
    assert {"metrics_tpu.Accuracy.update[aot]", "metrics_tpu.Accuracy.forward[aot]",
            "metrics_tpu.Accuracy.forward_step", "metrics_tpu.Accuracy.compute"} <= names
    assert isinstance(telemetry.profiler_range("x"), contextlib.nullcontext)  # no profiler: no range


# ------------------------------------------------------------------ snapshots
def _keys(tree):
    return {k: _keys(v) if isinstance(v, dict) and k != "members" else None for k, v in tree.items()}


def test_metric_telemetry_snapshot_has_the_jax_keys():
    rng = np.random.RandomState(17)
    p, t = _scores(rng, 8)
    jm, tm = metrics_tpu.Accuracy(num_classes=C, jit_update=True), metrics_tpu_torch.Accuracy(
        num_classes=C, jit_update=True, device="cpu")
    jm.update(_jax(p), _jax(t))
    tm.update(_torch(p), _torch(t))
    snap, jax_snap = tm.telemetry_snapshot(), jm.telemetry_snapshot()
    assert _keys(snap) == _keys(jax_snap)
    assert snap["aot_cache"] == {"hits": 0, "misses": 0, "stores": 0, "corrupt": 0, "store_errors": 0,
                                 "enabled": False, "dir": None}
    assert snap["dispatch"]["dispatches"] == jax_snap["dispatch"]["dispatches"] == 1
    assert snap["memory"]["total_bytes"] == jax_snap["memory"]["total_bytes"]


def test_collection_telemetry_snapshot_has_the_jax_keys():
    jax_mc = _collection(metrics_tpu, {}, False)
    mc = _collection(metrics_tpu_torch, {"device": "cpu"}, False)
    snap, jax_snap = mc.telemetry_snapshot(), jax_mc.telemetry_snapshot()
    assert _keys(snap) == _keys(jax_snap)
    assert sorted(snap["members"]) == sorted(jax_snap["members"])
    for name in snap["members"]:
        assert _keys(snap["members"][name]) == _keys(jax_snap["members"][name])


def test_an_unfusable_collection_emits_one_degrade_like_jax():
    def run(pkg, arr, dev):
        mc = pkg.MetricCollection([pkg.CatMetric(**dev), pkg.SumMetric(**dev)], fused_update=True)
        for v in (1.0, 2.0):
            mc.update(arr(np.float32(v)))

    jax_session, session = _both(run)
    assert _multiset(session) == _multiset(jax_session)
    (span,) = session.spans(name="degrade")
    assert (span.owner, span.kind, span.attrs["cause"], span.attrs["permanent"]) == (
        "MetricCollection", "update", "unfusable", True)


def test_an_idle_stream_adds_no_window_read():
    """With no session a tumbling tick emits nothing (its kind would be a host read of whether it advanced)
    and a sliding read's ``compute`` event carries no ``live`` count (a host read too); inside a session both
    are there, as in the JAX package."""
    def drive():
        tumbling = streaming.TumblingWindow(metrics_tpu_torch.SumMetric(device="cpu"), window=2, jit_update=False)
        sliding = streaming.SlidingWindow(metrics_tpu_torch.SumMetric(device="cpu"), window=4, slide=1,
                                          jit_update=False)
        for x in (1.0, 2.0, 3.0):
            tumbling.update(torch.tensor(x))
            sliding.update(torch.tensor(x))
        sliding.compute()

    telemetry.reset_counters()
    drive()
    idle = telemetry.snapshot()
    assert idle.get("window:advance", 0) + idle.get("window:update", 0) == 3  # the sliding window's ticks alone
    assert idle["window:compute"] == 1 and idle["read:window-cached"] == 1
    telemetry.reset_counters()
    with telemetry.instrument() as session:
        drive()
    ticks = [e for e in session.spans(name="window") if e.kind in ("advance", "update")]
    assert sorted(e.owner for e in ticks) == ["SlidingWindow"] * 3 + ["TumblingWindow"] * 3
    (read,) = session.spans(name="window", kind="compute")
    assert read.attrs["live"] == 3 and telemetry.snapshot()["window:compute"] == 1


# ------------------------------------------------------------------ the engine's stages, rows and marks
STAGE_ATTRS = ("prepare_us", "stage_us", "launch_us", "install_us")


def _segmentation_members(**kw):
    return [metrics_tpu_torch.JaccardIndex(num_classes=C, ignore_index=C - 1, update_method="matmul", **kw),
            metrics_tpu_torch.Accuracy(num_classes=C, ignore_index=C - 1, mdmc_average="global", **kw)]


def _segmentation_batch(rng, images):
    return (_torch(rng.rand(images, C, 4, 6).astype(np.float32)),
            _torch(rng.randint(0, C, (images, 4, 6)).astype(np.int64)))


@pytest.mark.parametrize("fused", [False, True], ids=["metric", "collection"])
def test_engine_spans_carry_their_stages_without_a_profiler(fused):
    rng = np.random.RandomState(20)
    if fused:
        owner = metrics_tpu_torch.MetricCollection(_segmentation_members(jit_update=True, device="cpu"),
                                                   fused_update=True)
        batch = lambda: _segmentation_batch(rng, 3)  # noqa: E731
    else:
        owner = metrics_tpu_torch.Accuracy(num_classes=C, jit_update=True, device="cpu")
        batch = lambda: tuple(map(_torch, _scores(rng, 8)))  # noqa: E731
    with telemetry.instrument() as session:
        for _ in range(3):
            owner.update(*batch())
    spans = session.spans(name="update")
    assert len(spans) == 3 and not torch._C._autograd._profiler_enabled()
    for span in spans:
        assert all(span.attrs[k] >= 0.0 for k in STAGE_ATTRS), span.attrs
        assert sum(span.attrs[k] for k in STAGE_ATTRS) <= span.dur_us
        assert span.attrs["launch_us"] > 0  # on the CPU the program runs in the launch stage
    rows = 3 if fused else 8
    assert [(s.attrs["rows"], s.attrs["bucket"]) for s in spans] == [(rows, rows)] * 3


def _stat_members():
    return [metrics_tpu_torch.Accuracy(num_classes=C, device="cpu"),
            metrics_tpu_torch.Recall(num_classes=C, average="macro", device="cpu")]


@pytest.mark.parametrize("members, batch, bucket_rows", [
    (_stat_members, lambda rng, n: tuple(map(_torch, _scores(rng, n))), 16),  # masked: 4 rows run as 8
    # a confusion matrix has no masked update: one program an exact shape, no padding
    (lambda: _segmentation_members(device="cpu"), _segmentation_batch, 12),
], ids=["masked", "exact"])
def test_the_rows_counters_hold_the_engine_s_padding(members, batch, bucket_rows):
    rng = np.random.RandomState(21)
    mc = metrics_tpu_torch.MetricCollection(members(), fused_update=True)
    telemetry.reset_counters()
    for images in (4, 8):
        mc.update(*batch(rng, images))
    counters = telemetry.snapshot()
    assert (counters["update:rows"], counters["update:bucket_rows"]) == (12, bucket_rows)
    assert counters["update:fused-aot"] == 2


def test_the_stage_compute_and_reset_ranges_under_a_profiler():
    rng = np.random.RandomState(22)
    mc = metrics_tpu_torch.MetricCollection(_segmentation_members(jit_update=True, device="cpu"), fused_update=True)
    mc.update(*_segmentation_batch(rng, 3))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        mc.update(*_segmentation_batch(rng, 3))
        mc.compute()
        mc.reset()
    events = [e for e in prof.events() if e.name.startswith("metrics_tpu.")]
    names = {e.name for e in events}
    # on the CPU the program runs as it is: no static inputs, so no ``stage`` range (the card's test has it)
    stages = [f"metrics_tpu.MetricCollection.update.{s}" for s in telemetry.STAGES if s != "stage"]
    assert {"metrics_tpu.MetricCollection.update[fused-aot]", *stages, "metrics_tpu.MetricCollection.compute",
            "metrics_tpu.MetricCollection.reset", "metrics_tpu.JaccardIndex.reset", "metrics_tpu.Accuracy.reset",
            "metrics_tpu.JaccardIndex.compute"} <= names
    (outer,) = [e for e in events if e.name == "metrics_tpu.MetricCollection.update[fused-aot]"]
    inner = sorted((e for e in events if e.name in stages), key=lambda e: e.time_range.start)
    assert [e.name for e in inner] == stages  # in order, each inside the call's range
    assert all(outer.time_range.start <= e.time_range.start <= e.time_range.end <= outer.time_range.end for e in inner)
    for name in ("metrics_tpu.MetricCollection.compute", "metrics_tpu.MetricCollection.reset"):
        assert isinstance(telemetry.profiler_range(name), contextlib.nullcontext)  # no profiler: no range


def test_the_chrome_export_lines_up_with_the_profiler_within_100_us(tmp_path):
    rng = np.random.RandomState(23)
    m = metrics_tpu_torch.Accuracy(num_classes=C, jit_update=True, device="cpu")
    m.update(*map(_torch, _scores(rng, 8)))
    with telemetry.instrument() as session, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(7):
            m.update(*map(_torch, _scores(rng, 8)))
    session.export_chrome_trace(str(tmp_path / "trace.json"))
    trace = json.loads((tmp_path / "trace.json").read_text())
    offset = trace["otherData"]["stream_offset_us"]
    spans = sorted(r["ts"] + offset for r in trace["traceEvents"] if r["name"] == "Accuracy.update [aot]")
    base = prof.profiler.kineto_results.trace_start_ns() / 1e3
    ranges = sorted(base + e.time_range.start for e in prof.events() if e.name == "metrics_tpu.Accuracy.update[aot]")
    assert len(spans) == len(ranges) == 7
    assert statistics.median(abs(a - b) for a, b in zip(spans, ranges)) < 100.0
    session.export_jsonl(str(tmp_path / "trace.jsonl"))
    lines = [json.loads(line) for line in (tmp_path / "trace.jsonl").read_text().splitlines()]
    assert all(abs(r["profiler_ts_us"] - (r["ts_us"] + offset)) < 1.0 for r in lines)


def test_the_marker_is_a_no_op_on_the_cpu_and_outside_a_capture():
    rng = np.random.RandomState(24)
    assert marks.mark("format", "Accuracy") is None and marks.mark("count") is None  # no capture: nothing
    with marks.recording(torch.device("cpu")) as marked:
        marks.mark("format", "Accuracy")
    assert marked == []
    with telemetry.instrument() as session:
        mc = metrics_tpu_torch.MetricCollection(_segmentation_members(jit_update=True, device="cpu"),
                                                fused_update=True)
        mc.update(*_segmentation_batch(rng, 3))
    (build,) = session.spans(name="compile")
    assert "marks" not in build.attrs and cost_model.lookup(build.attrs["cost_key"]).marks == ()


def test_the_kill_switch_leaves_out_stages_counters_ranges_and_marks(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_TELEMETRY", "0")
    telemetry.reset_counters()
    rng = np.random.RandomState(25)
    mc = metrics_tpu_torch.MetricCollection(_segmentation_members(jit_update=True, device="cpu"), fused_update=True)
    with telemetry.instrument() as session, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        mc.update(*_segmentation_batch(rng, 3))
        mc.compute()
        mc.reset()
        with marks.recording(torch.device("cuda")) as marked:  # telemetry off: no kernel is loaded, no mark placed
            marks.mark("format", "Accuracy")
    assert session.events == [] and telemetry.snapshot() == {} and marked == []
    assert not [e.name for e in prof.events() if e.name.startswith("metrics_tpu.")]
    assert mc.dispatch_stats["dispatches"] == 1
