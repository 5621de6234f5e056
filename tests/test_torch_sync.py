"""Distributed sync of the port (``metrics_tpu_torch``: ``parallel``,
``sync_engine``, ``Metric``/``MetricCollection`` sync) against the JAX
package, in one process.

Two loopback envs, each written once for each package:

* ``Fake2``: the JAX package's ``Fake2Env`` (``tests/bases/test_ddp.py:20``):
  both "ranks" contribute the local state;
* ``JaxPair``/``TorchPair``: two ranks as two threads, each with its own
  metric and data, meeting at a barrier in every gather, with the real envs'
  ``atleast_1d`` shapes (no native reduction, so every bucket crosses as one
  gather and a local reduce, as the JAX package's ``NoOpEnv``-based envs do).

The same numpy inputs go through both packages. Integer states, bool
states and ``sync_stats`` must be equal; float states agree to rtol 1e-6
(float32 sums of a few values in another order), and so do float values.
"""
import threading
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu_torch
from metrics_tpu.metric import Metric as JaxMetric
from metrics_tpu.parallel.dist_env import NoOpEnv as JaxNoOp
from metrics_tpu.utilities.exceptions import MetricsUserError as JaxUserError
from metrics_tpu_torch import Metric, MetricCollection
from metrics_tpu_torch.parallel import NoOpEnv, gather_all_tensors
from metrics_tpu_torch.utilities.exceptions import MetricsUserError

RTOL = 1e-6
TIMEOUT_S = 30


# ------------------------------------------------------------------ envs
class JaxFake2(JaxNoOp):
    def world_size(self):
        return 2

    def all_gather(self, x):
        return [x, x]


class TorchFake2(NoOpEnv):
    def world_size(self):
        return 2

    def all_gather(self, x):
        return [x, x]


class _Exchange:
    """The meeting point of two rank threads."""

    def __init__(self):
        self.barrier = threading.Barrier(2, timeout=TIMEOUT_S)
        self.slots = [None, None]

    def gather(self, rank, x):
        self.slots[rank] = x
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


class JaxPair(JaxNoOp):
    def __init__(self, exchange, rank):
        self.exchange, self.rank = exchange, rank

    def world_size(self):
        return 2

    def all_gather(self, x):
        return self.exchange.gather(self.rank, jnp.atleast_1d(x))


class TorchPair(NoOpEnv):
    def __init__(self, exchange, rank):
        self.exchange, self.rank = exchange, rank

    def world_size(self):
        return 2

    def all_gather(self, x):
        return self.exchange.gather(self.rank, torch.atleast_1d(x))


def run_ranks(fn, env_cls):
    """``fn(rank, env)`` on two threads, one a rank; their results, or the
    first rank's exception re-raised."""
    exchange = _Exchange()
    results, errors = [None, None], [None, None]

    def body(rank):
        try:
            results[rank] = fn(rank, env_cls(exchange, rank))
        except BaseException as err:  # noqa: BLE001 -- re-raised on the test's thread
            errors[rank] = err
            exchange.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT_S)
        assert not t.is_alive(), "a rank thread hung"
    # a rank that raised aborts the barrier, which can break the other rank's wait: the first error is the cause
    for err in sorted((e for e in errors if e is not None), key=lambda e: isinstance(e, threading.BrokenBarrierError)):
        raise err
    return results


# --------------------------------------------------------------- helpers
def np_of(x):
    if isinstance(x, list):
        return [np_of(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_same(t, j, what=""):
    """Port value ``t`` against JAX value ``j``: exact for integers and
    bools, rtol 1e-6 for floats; lists element by element."""
    if isinstance(j, list):
        assert isinstance(t, list) and len(t) == len(j), what
        for a, b in zip(t, j):
            assert_same(a, b, what)
        return
    t, j = np_of(t), np_of(j)
    assert t.shape == j.shape, f"{what}: {t.shape} vs {j.shape}"
    if np.issubdtype(j.dtype, np.floating):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=0, err_msg=what)
    else:
        assert t.dtype == j.dtype or (t.dtype.kind == j.dtype.kind and t.dtype.itemsize == j.dtype.itemsize), what
        np.testing.assert_array_equal(t, j, err_msg=what)


def states_of(m):
    return {k: np_of(getattr(m, k)) for k in m._defaults}


def assert_same_states(tm, jm, what=""):
    for k in jm._defaults:
        assert_same(getattr(tm, k), getattr(jm, k), f"{what} {k}")


def _rank_data(rank, n=24, seed=0):
    return np.random.RandomState(seed + 7 * rank).rand(n).astype(np.float32)


# --------------------------------------------------------------- metrics
def _sum2(x):
    return x.sum(0) * 2


class JaxAll(JaxMetric):
    """A state of every reduction: sum, mean, max (int32), min, bool max,
    cat (list), None (tensor and list) and a callable."""

    full_state_update = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("fsum", jnp.zeros(6, jnp.float32), dist_reduce_fx="sum")
        self.add_state("fmean", jnp.asarray(0.0), dist_reduce_fx="mean")
        self.add_state("imax", jnp.zeros(4, jnp.int32), dist_reduce_fx="max")
        self.add_state("fmin", jnp.full((3,), 1e9, jnp.float32), dist_reduce_fx="min")
        self.add_state("flag", jnp.asarray(False), dist_reduce_fx="max")
        self.add_state("isum", jnp.zeros(5, jnp.int32), dist_reduce_fx="sum")
        self.add_state("vals", [], dist_reduce_fx="cat")
        self.add_state("raw", jnp.zeros(2, jnp.float32), dist_reduce_fx=None)
        self.add_state("items", [], dist_reduce_fx=None)
        self.add_state("twice", jnp.zeros(3, jnp.float32), dist_reduce_fx=_sum2)

    def update(self, x):
        x = jnp.asarray(x)
        self.fsum = self.fsum + x[:6]
        self.fmean = self.fmean + x.mean()
        self.imax = jnp.maximum(self.imax, (x[:4] * 100).astype(jnp.int32))
        self.fmin = jnp.minimum(self.fmin, x[:3])
        self.flag = jnp.logical_or(self.flag, jnp.any(x > 0.9))
        self.isum = self.isum + (x[:5] * 50).astype(jnp.int32)
        self.vals.append(x[:4])
        self.raw = self.raw + x[:2]
        self.items.append(x[4:6])
        self.twice = self.twice + x[6:9]

    def compute(self):
        return self.fsum.sum()


class TorchAll(Metric):
    full_state_update = True

    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("fsum", torch.zeros(6), dist_reduce_fx="sum")
        self.add_state("fmean", 0.0, dist_reduce_fx="mean")
        self.add_state("imax", torch.zeros(4, dtype=torch.int32), dist_reduce_fx="max")
        self.add_state("fmin", torch.full((3,), 1e9), dist_reduce_fx="min")
        self.add_state("flag", torch.tensor(False), dist_reduce_fx="max")
        self.add_state("isum", torch.zeros(5, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("vals", [], dist_reduce_fx="cat")
        self.add_state("raw", torch.zeros(2), dist_reduce_fx=None)
        self.add_state("items", [], dist_reduce_fx=None)
        self.add_state("twice", torch.zeros(3), dist_reduce_fx=_sum2)

    def update(self, x):
        self.fsum = self.fsum + x[:6]
        self.fmean = self.fmean + x.mean()
        self.imax = torch.maximum(self.imax, (x[:4] * 100).to(torch.int32))
        self.fmin = torch.minimum(self.fmin, x[:3])
        self.flag = self.flag | (x > 0.9).any()
        self.isum = self.isum + (x[:5] * 50).to(torch.int32)
        self.vals.append(x[:4])
        self.raw = self.raw + x[:2]
        self.items.append(x[4:6])
        self.twice = self.twice + x[6:9]

    def compute(self):
        return self.fsum.sum()


class JaxVec(JaxMetric):
    """A float32 vector (sum), an int32 count vector (sum) and a float32
    scalar (sum): the quantised wire's float, integer and too-small cases."""

    full_state_update = False

    def __init__(self, n=1024, **kwargs):
        super().__init__(**kwargs)
        self.add_state("value", jnp.zeros((n,), jnp.float32), dist_reduce_fx="sum")
        self.add_state("counts", jnp.zeros((n,), jnp.int32), dist_reduce_fx="sum")
        self.add_state("total", jnp.asarray(0.0), dist_reduce_fx="sum")

    def update(self, x):
        x = jnp.asarray(x)
        self.value = self.value + x
        self.counts = self.counts + (x * 60).astype(jnp.int32)
        self.total = self.total + x.sum()

    def compute(self):
        return self.value.sum()


class TorchVec(Metric):
    full_state_update = False

    def __init__(self, n=1024, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("value", torch.zeros(n), dist_reduce_fx="sum")
        self.add_state("counts", torch.zeros(n, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("total", 0.0, dist_reduce_fx="sum")

    def update(self, x):
        self.value = self.value + x
        self.counts = self.counts + (x * 60).to(torch.int32)
        self.total = self.total + x.sum()

    def compute(self):
        return self.value.sum()


def _synced_pair(make_j, make_t, batches, **sync_kwargs):
    """Both packages' metrics updated with each rank's batches and synced on
    two rank threads: ``(port metrics, JAX metrics, port stats, JAX stats)``
    per rank, the metrics left synced."""

    def run(pkg):
        make, env_cls, conv = (make_j, JaxPair, jnp.asarray) if pkg == "jax" else (make_t, TorchPair, torch.from_numpy)

        def rank_fn(rank, env):
            m = make()
            for b in batches[rank]:
                m.update(conv(b))
            m.sync(env=env, **sync_kwargs)
            return m

        return run_ranks(rank_fn, env_cls)

    return run("torch"), run("jax")


# ----------------------------------------------------------------- tests
@pytest.mark.parametrize("fused", ["1", "0"])
def test_every_reduction_equal_to_jax_on_two_ranks(fused, monkeypatch):
    monkeypatch.setenv("METRICS_TPU_FUSED_SYNC", fused)
    batches = [[_rank_data(r, seed=s) for s in range(3)] for r in range(2)]
    tms, jms = _synced_pair(JaxAll, TorchAll, batches)
    for r in range(2):
        assert_same_states(tms[r], jms[r], f"rank {r}")
        assert tms[r].sync_stats == jms[r].sync_stats
    assert tms[0].sync_stats["buckets"] == (5 if fused == "1" else 0)


def test_fake2_env_equal_to_jax():
    jm, tm = JaxAll(), TorchAll()
    for s in range(2):
        jm.update(jnp.asarray(_rank_data(0, seed=s)))
        tm.update(torch.from_numpy(_rank_data(0, seed=s)))
    jm.sync(env=JaxFake2())
    tm.sync(env=TorchFake2())
    assert_same_states(tm, jm)
    assert tm.sync_stats == jm.sync_stats
    tm.unsync()
    jm.unsync()
    assert_same_states(tm, jm)


def test_all_empty_list_states_stay_empty_and_mixed_emptiness_raises_like_jax():
    def jax_fn(updates):
        def fn(rank, env):
            m = metrics_tpu.CatMetric()
            for _ in range(updates[rank]):
                m.update(jnp.asarray([1.0, 2.0]))
            m.sync(env=env)
            return m.value

        return fn

    def torch_fn(updates):
        def fn(rank, env):
            m = metrics_tpu_torch.CatMetric(device="cpu")
            for _ in range(updates[rank]):
                m.update(torch.tensor([1.0, 2.0]))
            m.sync(env=env)
            return m.value

        return fn

    assert run_ranks(torch_fn((0, 0)), TorchPair) == [[], []] == run_ranks(jax_fn((0, 0)), JaxPair)
    with pytest.raises(JaxUserError) as jerr:
        run_ranks(jax_fn((2, 0)), JaxPair)
    with pytest.raises(MetricsUserError) as terr:
        run_ranks(torch_fn((2, 0)), TorchPair)
    assert "per-rank element counts [2, 0]" in str(terr.value)
    assert str(terr.value).split(" A generic")[0] == str(jerr.value).split(" A generic")[0]


@pytest.mark.parametrize("empty_rank", [None, 0, 1])
def test_ragged_retrieval_states_with_an_empty_rank_equal_to_jax(empty_rank):
    rng = np.random.RandomState(5)
    shards = []
    for r in range(2):
        ups = []
        for u in range(0 if r == empty_rank else 2 + r):
            n = 5 + 3 * u + r
            ups.append((rng.rand(n).astype(np.float32), (rng.rand(n) > 0.6).astype(np.int64),
                        rng.randint(0, 6, size=n).astype(np.int64) + 10 * r))
        shards.append(ups)

    def make(pkg):
        def fn(rank, env):
            if pkg == "jax":
                m = metrics_tpu.RetrievalMAP()
                for p, t, i in shards[rank]:
                    m.update(jnp.asarray(p), jnp.asarray(t), indexes=jnp.asarray(i))
            else:
                m = metrics_tpu_torch.RetrievalMAP(device="cpu")
                for p, t, i in shards[rank]:
                    m.update(torch.from_numpy(p), torch.from_numpy(t), indexes=torch.from_numpy(i))
            m.sync(env=env)
            out = {k: np_of(getattr(m, k)) for k in ("indexes", "preds", "target")}
            m.unsync()
            m._to_sync = False  # the value of the synced rows: a second sync at compute is not wanted here
            out["value"] = None
            m.sync(env=env)
            out["value"] = np_of(m._compute_impl())
            out["stats"] = m.sync_stats
            return out

        return fn

    touts = run_ranks(make("torch"), TorchPair)
    jouts = run_ranks(make("jax"), JaxPair)
    for t, j in zip(touts, jouts):
        for k in ("indexes", "preds", "target"):
            assert len(t[k]) == len(j[k]) == sum(len(s) for s in shards)
            for a, b in zip(t[k], j[k]):
                np.testing.assert_allclose(a, b, rtol=RTOL)
        np.testing.assert_allclose(t["value"], j["value"], rtol=RTOL)
        assert t["stats"] == j["stats"]
    # one lengths gather serves the three states (lengths_group "rows"): 1 + 3 gathers a sync
    assert touts[0]["stats"]["collectives"] == 2 * 4


def test_ragged_group_disagreement_raises_like_jax():
    jm = metrics_tpu.RetrievalMAP()
    tm = metrics_tpu_torch.RetrievalMAP(device="cpu")
    jm.update(jnp.asarray([0.5, 0.2]), jnp.asarray([1, 0]), indexes=jnp.asarray([0, 0]))
    tm.update(torch.tensor([0.5, 0.2]), torch.tensor([1, 0]), indexes=torch.tensor([0, 0]))
    jm.preds.append(jnp.asarray([0.3]))
    tm.preds.append(torch.tensor([0.3]))
    with pytest.raises(JaxUserError, match="lengths_group") as jerr:
        jm.sync(env=JaxFake2())
    with pytest.raises(MetricsUserError, match="lengths_group") as terr:
        tm.sync(env=TorchFake2())
    assert str(terr.value) == str(jerr.value).replace("jnp", "torch")


def test_sync_dtype_bfloat16_equal_to_jax():
    batches = [[_rank_data(r, n=1024, seed=s) * 100 for s in range(2)] for r in range(2)]
    tms, jms = _synced_pair(lambda: JaxVec(sync_dtype=jnp.bfloat16), lambda: TorchVec(sync_dtype=torch.bfloat16),
                            batches)
    for r in range(2):
        assert_same_states(tms[r], jms[r], f"rank {r}")
        assert tms[r].sync_stats == jms[r].sync_stats
    # float leaves crossed narrowed, reduced after the cast back: not the full-precision sum
    full = sum(b for rank in batches for b in rank)
    assert not np.array_equal(np_of(tms[0].value), full)


@pytest.mark.parametrize("quant_on", ["1", "0"])
def test_sync_precision_int8_float_int_and_scalar_leaves_equal_to_jax(quant_on, monkeypatch):
    monkeypatch.setenv("METRICS_TPU_QUANT_SYNC", quant_on)
    batches = [[_rank_data(r, n=1024, seed=s) for s in range(2)] for r in range(2)]
    tms, jms = _synced_pair(lambda: JaxVec(sync_precision="int8"), lambda: TorchVec(sync_precision="int8"), batches)
    for r in range(2):
        assert_same_states(tms[r], jms[r], f"rank {r}")
        assert tms[r].sync_stats == jms[r].sync_stats
    stats = tms[0].sync_stats
    if quant_on == "1":
        # value and the scalar total share the float32 bucket, counts the int32 one: both on the int8 wire
        codec = metrics_tpu_torch.quant.QuantCodec("q8")
        assert stats["bytes_on_wire"] == sum(metrics_tpu_torch.quant.bucket_wire_nbytes(n, codec) for n in (1025, 1024))
        exact = sum((b * 60).astype(np.int32) for rank in batches for b in rank)
        # each rank's counts stay at most 127 a block (quant.INT_EXACT_BOUND): exact through the int8 wire
        np.testing.assert_array_equal(np_of(tms[0].counts), exact)
    else:
        assert stats["bytes_on_wire"] == 1024 * 4 * 2 + 4


def test_quantize_false_keeps_a_leaf_full_precision_like_jax():
    class J(JaxVec):
        def __init__(self):
            super().__init__(sync_precision="int8")
            self._quantize["value"] = False

    class T(TorchVec):
        def __init__(self):
            super().__init__(sync_precision="int8")
            self._quantize["value"] = False

    batches = [[_rank_data(r, n=1024)] for r in range(2)]
    tms, jms = _synced_pair(J, T, batches)
    assert_same_states(tms[0], jms[0])
    assert tms[0].sync_stats == jms[0].sync_stats
    np.testing.assert_array_equal(np_of(tms[0].value), batches[0][0] + batches[1][0])


@pytest.mark.parametrize("quant_on", ["1", "0"])
def test_sketches_on_the_int8_wire_equal_to_jax(quant_on, monkeypatch):
    monkeypatch.setenv("METRICS_TPU_QUANT_SYNC", quant_on)
    rng = np.random.RandomState(11)
    batches = [[rng.zipf(1.2, size=4000).astype(np.float32) for _ in range(2)] for _ in range(2)]
    pairs = {
        "hll": (lambda: metrics_tpu.HyperLogLog(precision=12, sync_precision="int8"),
                lambda: metrics_tpu_torch.HyperLogLog(precision=12, sync_precision="int8", device="cpu")),
        "countmin": (lambda: metrics_tpu.CountMinHeavyHitters(sync_precision="int8"),
                     lambda: metrics_tpu_torch.CountMinHeavyHitters(sync_precision="int8", device="cpu")),
        "quantile": (lambda: metrics_tpu.QuantileSketch(sync_precision="int8"),
                     lambda: metrics_tpu_torch.QuantileSketch(sync_precision="int8", device="cpu")),
    }
    for name, (make_j, make_t) in pairs.items():
        tms, jms = _synced_pair(make_j, make_t, batches)
        for r in range(2):
            assert_same_states(tms[r], jms[r], f"{name} rank {r}")
            assert tms[r].sync_stats == jms[r].sync_stats, name
        if name == "hll":  # registers cross as bit planes: the union, bit for bit
            locals_ = []
            for rank in batches:
                h = metrics_tpu_torch.HyperLogLog(precision=12, device="cpu")
                for b in rank:
                    h.update(torch.from_numpy(b))
                locals_.append(np_of(h.value))
            np.testing.assert_array_equal(np_of(tms[0].value), np.maximum(*locals_))
        if name == "countmin":  # never below the exact table
            exact = metrics_tpu_torch.CountMinHeavyHitters(device="cpu")
            for rank in batches:
                for b in rank:
                    exact.update(torch.from_numpy(b))
            assert np.all(np_of(tms[0].value) >= np_of(exact.value))


def test_fused_kill_switch_same_values_more_collectives(monkeypatch):
    batches = [[_rank_data(r, seed=s) for s in range(2)] for r in range(2)]
    fused = _synced_pair(JaxAll, TorchAll, batches)[0]
    monkeypatch.setenv("METRICS_TPU_FUSED_SYNC", "0")
    per_leaf = _synced_pair(JaxAll, TorchAll, batches)[0]
    assert_same_states(per_leaf[0], fused[0])
    assert per_leaf[0].sync_stats["collectives"] > fused[0].sync_stats["collectives"]


def test_shard_state_kill_switch_and_loopback_keep_leaves_whole(monkeypatch):
    """A loopback env speaks for no group, so a sharded leaf syncs whole, as
    the JAX package's does outside a matching mesh axis; with
    ``METRICS_TPU_SHARD_STATE=0`` too."""
    for switch in ("1", "0"):
        monkeypatch.setenv("METRICS_TPU_SHARD_STATE", switch)
        jm = metrics_tpu.ConfusionMatrix(num_classes=4, shard_state="dp")
        tm = metrics_tpu_torch.ConfusionMatrix(num_classes=4, shard_state="world", device="cpu")
        p, t = np.array([0, 1, 2, 3, 1]), np.array([0, 1, 1, 3, 2])
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
        jm.sync(env=JaxFake2())
        tm.sync(env=TorchFake2())
        assert_same(tm.confmat, jm.confmat)
        assert tm.sync_stats == jm.sync_stats
        assert tm.sharded_axes() == ({"confmat": "world"} if switch == "1" else {})


def test_dist_sync_on_step_equal_to_jax():
    """The first step against the JAX package; later steps against their
    value. The JAX package leaves the metric synced after a step
    (``metrics_tpu/metric.py:649-667`` never clears ``_is_synced``), so its
    second ``forward`` raises; the port clears it, as TorchMetrics does."""
    batches = [_rank_data(0, seed=s) for s in range(3)]
    jm = metrics_tpu.SumMetric(dist_sync_on_step=True, sync_env=JaxFake2())
    tm = metrics_tpu_torch.SumMetric(dist_sync_on_step=True, sync_env=TorchFake2(), device="cpu")
    assert_same(tm(torch.from_numpy(batches[0])), jm(jnp.asarray(batches[0])))
    assert_same(tm.value, jm.value)  # the accumulated state stays local
    assert tm.sync_stats == jm.sync_stats
    with pytest.raises(JaxUserError, match="shouldn't be synced"):
        jm(jnp.asarray(batches[1]))
    for b in batches[1:]:
        np.testing.assert_allclose(np_of(tm(torch.from_numpy(b))), 2 * b.sum(), rtol=RTOL)
    np.testing.assert_allclose(np_of(tm.value), sum(b.sum() for b in batches), rtol=RTOL)
    np.testing.assert_allclose(np_of(tm.compute()), 2 * sum(b.sum() for b in batches), rtol=RTOL)
    assert tm.sync_stats["collectives"] == 4


def test_sync_context_unsync_and_errors_like_jax():
    tm = metrics_tpu_torch.SumMetric(device="cpu", sync_env=TorchFake2())
    tm.update(torch.tensor([1.0, 2.0]))
    with tm.sync_context():
        assert float(tm.value.reshape(())) == 6.0 and tm._is_synced
        with pytest.raises(MetricsUserError, match="already been synced"):
            tm.sync()
        with pytest.raises(MetricsUserError, match="shouldn't be synced"):
            tm(torch.tensor(1.0))
    assert float(tm.value) == 3.0 and not tm._is_synced
    with pytest.raises(MetricsUserError, match="already been un-synced"):
        tm.unsync()
    assert float(tm.compute()) == 6.0  # compute syncs, and leaves the local state
    assert float(tm.value) == 3.0
    # a world of one: nothing to sync
    one = metrics_tpu_torch.SumMetric(device="cpu")
    one.update(torch.tensor(2.0))
    one.sync()
    assert not one._is_synced and one.sync_stats["collectives"] == 0


def test_custom_dist_sync_fn_sees_every_state_like_jax():
    seen_j, seen_t = [], []

    def jfn(x, env):
        seen_j.append(tuple(np.shape(x)))
        return [x, x]

    def tfn(x, env):
        seen_t.append(tuple(x.shape))
        return [x, x]

    jm, tm = JaxVec(n=8, dist_sync_fn=jfn), TorchVec(n=8, dist_sync_fn=tfn)
    jm.update(jnp.ones(8))
    tm.update(torch.ones(8))
    jm.sync(env=JaxFake2())
    tm.sync(env=TorchFake2())
    assert seen_t == seen_j and len(seen_t) == 3
    assert_same_states(tm, jm)
    assert tm.sync_stats == jm.sync_stats and tm.sync_stats["buckets"] == 0


def _collection_pair(pkg, env):
    if pkg == "jax":
        m = metrics_tpu
        kw = {}
    else:
        m = metrics_tpu_torch
        kw = {"device": "cpu"}
    return m.MetricCollection(
        [
            m.Accuracy(num_classes=5, average="macro", **kw),
            m.Precision(num_classes=5, average="macro", **kw),
            m.Recall(num_classes=5, average="macro", **kw),
            m.HammingDistance(**kw),
            m.ConfusionMatrix(num_classes=5, **kw),
            m.CohenKappa(num_classes=5, **kw),
        ],
        prefix="val_",
    )


@pytest.mark.parametrize("fused", ["1", "0"])
def test_collection_one_bucket_pass_with_compute_groups_equal_to_jax(fused, monkeypatch):
    monkeypatch.setenv("METRICS_TPU_FUSED_SYNC", fused)
    rng = np.random.RandomState(2)
    data = [[(rng.rand(16, 5).astype(np.float32), rng.randint(0, 5, size=16)) for _ in range(3)] for _ in range(2)]

    def make(pkg):
        conv = jnp.asarray if pkg == "jax" else torch.from_numpy

        def fn(rank, env):
            mc = _collection_pair(pkg, env)
            for p, t in data[rank]:
                mc.update(conv(p), conv(t))
            for member in mc.values():
                member._sync_env = env
            values = mc.compute()
            return (
                {k: np_of(v) for k, v in values.items()},
                dict(mc.sync_stats),
                {k: dict(member.sync_stats) for k, member in mc.items(keep_base=True)},
                {k: int(member._is_synced) for k, member in mc.items(keep_base=True)},
                {k: states_of(member) for k, member in mc.items(keep_base=True)},
            )

        return fn

    touts = run_ranks(make("torch"), TorchPair)
    jouts = run_ranks(make("jax"), JaxPair)
    for t, j in zip(touts, jouts):
        assert t[0].keys() == j[0].keys()
        for k in j[0]:
            assert_same(t[0][k], j[0][k], k)
        assert t[1] == j[1]
        assert t[2] == j[2]
        assert t[3] == j[3] and not any(t[3].values())  # unsynced after compute
        for k in j[4]:  # and the local states back
            for leaf in j[4][k]:
                assert_same(t[4][k][leaf], j[4][k][leaf], f"{k}.{leaf}")
    if fused == "1":
        # the three groups' leaders hold int32 sums only: one bucket, one collective for the collection
        assert touts[0][1]["collectives"] == 1 and touts[0][1]["buckets"] == 1
        assert all(stats["collectives"] == 0 for stats in touts[0][2].values())


def test_collection_sync_context_and_pure_sync_equal_to_jax():
    tm = _collection_pair("torch", None)
    jm = _collection_pair("jax", None)
    rng = np.random.RandomState(4)
    for _ in range(2):
        p, t = rng.rand(8, 5).astype(np.float32), rng.randint(0, 5, size=8)
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
        jm.update(jnp.asarray(p), jnp.asarray(t))
    with tm.sync_context(env=TorchFake2()), jm.sync_context(env=JaxFake2()):
        tv, jv = tm.compute(), jm.compute()
        for k in jv:
            assert_same(tv[k], jv[k], k)
        with pytest.raises(MetricsUserError, match="already been synced"):
            tm.sync(env=TorchFake2())
    assert tm.sync_stats == jm.sync_stats
    tstates = tm.pure_sync(tm.state(), env=TorchFake2())
    # the JAX package's pure_sync takes a mesh axis; its sync over the same env gives the states to hold against
    # (a memoised member does not sync again: drop the memos of the compute above)
    for member in jm.values():
        member._computed = None
    with jm.sync_context(env=JaxFake2()):
        for name, member in jm.items(keep_base=True):
            for leaf in member._defaults:
                assert_same(tstates[name][leaf], getattr(member, leaf), f"{name}.{leaf}")


def test_jit_update_metric_syncs_its_engine_state_like_eager():
    """update, compute, update, compute through the engine, synced, equals
    the eager run, and the engine goes on from its own leaves after unsync."""
    outs = {}
    for jit in (False, True):
        m = metrics_tpu_torch.Accuracy(num_classes=4, average="macro", jit_update=jit, device="cpu",
                                       sync_env=TorchFake2())
        rng = np.random.RandomState(9)
        vals = []
        for _ in range(2):
            m.update(torch.from_numpy(rng.rand(12, 4).astype(np.float32)), torch.from_numpy(rng.randint(0, 4, 12)))
            vals.append(np_of(m.compute()))
        outs[jit] = (vals, states_of(m), m.sync_stats)
    np.testing.assert_array_equal(outs[True][0], outs[False][0])
    for k in outs[False][1]:
        np.testing.assert_array_equal(outs[True][1][k], outs[False][1][k])
    assert outs[True][2] == outs[False][2]


def test_fused_collection_syncs_like_the_eager_one_and_jax():
    rng = np.random.RandomState(12)
    data = [(rng.rand(16, 5).astype(np.float32), rng.randint(0, 5, size=16)) for _ in range(3)]
    values = {}
    for fused in (False, True):
        mc = metrics_tpu_torch.MetricCollection(
            [metrics_tpu_torch.Accuracy(num_classes=5, average="macro", device="cpu"),
             metrics_tpu_torch.ConfusionMatrix(num_classes=5, device="cpu")],
            fused_update=fused,
        )
        for p, t in data:
            mc.update(torch.from_numpy(p), torch.from_numpy(t))
        with mc.sync_context(env=TorchFake2()):
            values[fused] = {k: np_of(v) for k, v in mc.compute().items()}
        assert mc.sync_stats["buckets"] == 1
    jm = metrics_tpu.MetricCollection([metrics_tpu.Accuracy(num_classes=5, average="macro"),
                                       metrics_tpu.ConfusionMatrix(num_classes=5)])
    for p, t in data:
        jm.update(jnp.asarray(p), jnp.asarray(t))
    with jm.sync_context(env=JaxFake2()):
        jv = jm.compute()
    for k in jv:
        np.testing.assert_array_equal(values[True][k], values[False][k])
        assert_same(values[True][k], jv[k], k)


def test_gather_all_tensors_and_the_one_process_env():
    x = torch.arange(3)
    assert [g.tolist() for g in gather_all_tensors(x)] == [[0, 1, 2]]
    assert [g.tolist() for g in gather_all_tensors(x, env=TorchFake2())] == [[0, 1, 2]] * 2
    assert metrics_tpu_torch.parallel.default_env().world_size() == 1


def test_constructor_checks_like_jax():
    for kwargs, match in (
        ({"dist_sync_on_step": 1}, "dist_sync_on_step"),
        ({"dist_sync_fn": 3}, "dist_sync_fn"),
        ({"sync_dtype": torch.int32}, "sync_dtype"),
        ({"sync_precision": "int4"}, "sync_precision"),
    ):
        with pytest.raises(ValueError, match=match):
            metrics_tpu_torch.SumMetric(device="cpu", **kwargs)
        jkw = {k: (jnp.int32 if v is torch.int32 else v) for k, v in kwargs.items()}
        with pytest.raises(ValueError, match=match):
            metrics_tpu.SumMetric(**jkw)
    with pytest.raises(ValueError, match="sync_precision"):
        MetricCollection([metrics_tpu_torch.SumMetric(device="cpu")], sync_precision="fp8")
    with pytest.raises(ValueError, match="scalar default"):
        TorchVec().add_state("bad", 0.0, shard_state="world")


# ------------------------------------------------- compute_on_cpu, fused fallback
@pytest.mark.parametrize("member", ["dist_sync_on_step", "compute_on_cpu"])
def test_fused_collection_serves_a_member_that_syncs_on_step_or_moves_to_the_cpu_eagerly_like_jax(member):
    """A member with ``dist_sync_on_step`` or ``compute_on_cpu`` keeps the
    collection off the fused engine, as in the JAX package
    (``metrics_tpu/collections.py:283``). Before that exclusion the fused
    forward gave ``s`` the unsynced batch value, 3.0, where the eager forward
    and the JAX package give the synced 6.0."""
    x = np.array([1.0, 2.0], np.float32)
    kw = {"dist_sync_on_step": True} if member == "dist_sync_on_step" else {"compute_on_cpu": True}
    values, fused_calls = {}, {}
    for fused in (False, True):
        mc = MetricCollection({"s": metrics_tpu_torch.SumMetric(sync_env=TorchFake2(), device="cpu", **kw),
                               "t": metrics_tpu_torch.SumMetric(device="cpu")}, fused_update=fused)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the explicit fused_update=True hears of the fallback
            values[fused] = {k: np_of(v) for k, v in mc(torch.from_numpy(x)).items()}
        fused_calls[fused] = mc.forward_stats.get("launches", 0)
    jm = metrics_tpu.MetricCollection({"s": metrics_tpu.SumMetric(sync_env=JaxFake2(), **kw),
                                       "t": metrics_tpu.SumMetric()}, fused_update=True)
    jv = jm(jnp.asarray(x))
    want_s = 6.0 if member == "dist_sync_on_step" else 3.0
    for fused in (False, True):
        assert float(values[fused]["s"]) == float(jv["s"]) == want_s
        assert float(values[fused]["t"]) == float(jv["t"]) == 3.0
    assert fused_calls[True] == 0


def test_compute_on_cpu_list_states_sync_through_the_env_like_jax():
    """``compute_on_cpu`` list states, on the CPU after every update, sync
    through the metric's env: a loopback env against the JAX package's, and
    two rank threads against one metric over both ranks' data."""
    rng = np.random.RandomState(30)
    # int32 labels: the JAX package holds them so (x64 off), and the bytes on the wire are compared
    data = [[(rng.rand(20, 4).astype(np.float32), rng.randint(0, 4, 20).astype(np.int32)) for _ in range(2)]
            for _ in range(2)]
    jm = metrics_tpu.AUROC(num_classes=4, compute_on_cpu=True, sync_env=JaxFake2())
    tm = metrics_tpu_torch.AUROC(num_classes=4, compute_on_cpu=True, sync_env=TorchFake2(), device="cpu")
    for p, t in data[0]:
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
    np.testing.assert_allclose(np_of(tm.compute()), np_of(jm.compute()), rtol=1e-5, atol=0)
    assert tm.sync_stats == jm.sync_stats and tm.sync_stats["collectives"] > 0
    assert all(v.device.type == "cpu" for v in tm.preds) and len(tm.preds) == 2  # local again after compute

    def rank_fn(rank, env):
        m = metrics_tpu_torch.AUROC(num_classes=4, compute_on_cpu=True, sync_env=env, device="cpu")
        for p, t in data[rank]:
            m.update(torch.from_numpy(p), torch.from_numpy(t))
        return np_of(m.compute())

    whole = metrics_tpu.AUROC(num_classes=4)
    for p, t in data[0] + data[1]:
        whole.update(jnp.asarray(p), jnp.asarray(t))
    for value in run_ranks(rank_fn, TorchPair):
        np.testing.assert_allclose(value, np_of(whole.compute()), rtol=1e-5, atol=0)
