"""The port's sync across real processes: four ``gloo`` ranks on the CPU.

Each test spawns four worker processes (``spawn``) that meet through a
``file://`` rendezvous under the test's ``tmp_path`` (no fixed TCP port, so
files run in parallel), run one scenario on seeded shards and send their
results back. A test joins its workers within ``JOIN_S`` seconds and kills
them on expiry, so a hang fails that test alone.

The synced values are held against the JAX package's ``pure_sync`` inside
``shard_map`` over four of the eight forced host devices (as
``tests/helpers/testers.py:225-245`` runs it) and against the port in one
process on all rows. Integer states and counts must be equal; float values
agree to rtol 1e-6.

This module imports neither JAX nor the JAX package at its top: the workers
import it, and run the port alone.
"""
import datetime
import os
import queue
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import metrics_tpu_torch as M
from metrics_tpu_torch import resilience
from metrics_tpu_torch.parallel import ProcessEnv

WORLD, ROWS, CLASSES, BATCH = 4, 256, 10, 64
SHARD_CLASSES = 12  # a leading dim the four ranks divide
JOIN_S = 60
DEADLINE_S = 2  # the timeout of the deadline scenario's own group
RTOL = 1e-6


# ------------------------------------------------------------------ data
def imagenet_like(seed=0):
    """4 x 256 rows of C = 10 class scores (softmax of seeded logits, the
    label on top for 3 rows in 4) and their labels."""
    rng = np.random.RandomState(seed)
    n = WORLD * ROWS
    target = rng.randint(0, CLASSES, size=n)
    logits = rng.randn(n, CLASSES).astype(np.float32)
    hit = rng.rand(n) < 0.75
    logits[np.arange(n)[hit], target[hit]] = logits[hit].max(axis=1) + 1.0
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32), target.astype(np.int64)


def retrieval_like(seed=1):
    """40 queries of 5-30 candidates, 1-2 relevant each, scores on 1/16 (ties),
    split over the ranks by query: 14, 3, 23 and 0 queries (rank 3 holds none)."""
    rng = np.random.RandomState(seed)
    rows = []
    for q in range(40):
        n = rng.randint(5, 31)
        target = np.zeros(n, dtype=np.int64)
        target[rng.choice(n, size=1 + int(rng.rand() < 0.3), replace=False)] = 1
        preds = (np.round((rng.randn(n) + 2 * target) * 16) / 16).astype(np.float32)
        rows.append((preds, target, np.full(n, q, dtype=np.int64)))
    bounds = [0, 14, 17, 40, 40]
    return rows, [rows[bounds[r]:bounds[r + 1]] for r in range(WORLD)]


def click_like(seed=2):
    rng = np.random.RandomState(seed)
    return rng.zipf(1.2, size=WORLD * 20000).clip(max=50000).astype(np.float32)


def collection(device="cpu", **kwargs):
    return M.MetricCollection(
        [
            M.Accuracy(num_classes=CLASSES, average="macro", device=device),
            M.Precision(num_classes=CLASSES, average="macro", device=device),
            M.F1Score(num_classes=CLASSES, average="macro", device=device),
            M.HammingDistance(device=device),
            M.ConfusionMatrix(num_classes=CLASSES, update_method="matmul", device=device),
            M.CohenKappa(num_classes=CLASSES, weights="quadratic", update_method="matmul", device=device),
            M.JaccardIndex(num_classes=CLASSES, update_method="matmul", device=device),
        ],
        prefix="val_",
        **kwargs,
    )


RETRIEVAL = ("RetrievalMAP", "RetrievalMRR", "RetrievalNormalizedDCG")


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------- scenarios
def scenario_classification(rank):
    preds, target = imagenet_like()
    lo = rank * ROWS
    out = {}
    for fused in ("1", "0"):
        os.environ["METRICS_TPU_FUSED_SYNC"] = fused
        mc = collection()
        for i in range(lo, lo + ROWS, BATCH):
            mc.update(torch.from_numpy(preds[i:i + BATCH]), torch.from_numpy(target[i:i + BATCH]))
        out[f"values{fused}"] = _np(mc.compute())
        out[f"collectives{fused}"] = mc.sync_stats["collectives"] + sum(
            m.sync_stats["collectives"] for m in mc.values(copy_state=False))
        out[f"buckets{fused}"] = mc.sync_stats["buckets"]
        # the local states are back after compute
        out[f"local_tp{fused}"] = _np(mc["Accuracy"].tp)
    os.environ.pop("METRICS_TPU_FUSED_SYNC")
    # a jit_update metric: update, compute, update, compute, synced, against the eager run
    for jit in (False, True):
        acc = M.Accuracy(num_classes=CLASSES, average="macro", jit_update=jit, device="cpu")
        vals = []
        for i in range(lo, lo + ROWS, 2 * BATCH):
            acc.update(torch.from_numpy(preds[i:i + BATCH]), torch.from_numpy(target[i:i + BATCH]))
            acc.update(torch.from_numpy(preds[i + BATCH:i + 2 * BATCH]),
                       torch.from_numpy(target[i + BATCH:i + 2 * BATCH]))
            vals.append(_np(acc.compute()))
        out[f"acc_jit{int(jit)}"] = np.stack(vals)
    return out


def scenario_sharded(rank):
    preds, target = imagenet_like()
    lo = rank * ROWS
    out = {}
    for precision in (None, "int8"):
        cm = M.ConfusionMatrix(num_classes=SHARD_CLASSES, update_method="matmul", shard_state="world",
                               sync_precision=precision, device="cpu")
        for i in range(lo, lo + ROWS, BATCH):
            cm.update(torch.from_numpy(target[i:i + BATCH][::-1].copy()), torch.from_numpy(target[i:i + BATCH]))
        synced = cm.pure_sync(cm.state())
        tag = precision or "full"
        out[f"shard_{tag}"] = _np(synced["confmat"])
        out[f"assembled_{tag}"] = _np(cm.assemble_sharded(synced)["confmat"])
        out[f"value_{tag}"] = _np(cm.pure_compute_sharded(synced))
        out[f"stats_{tag}"] = cm.sync_stats
        # the stateful compute syncs whole (the JAX package's ProcessEnv never shards)
        out[f"compute_{tag}"] = _np(cm.compute())
    return out


def scenario_retrieval(rank):
    _, shards = retrieval_like()
    out = {}
    for name in RETRIEVAL:
        m = getattr(M, name)(device="cpu")
        for p, t, i in shards[rank]:
            m.update(torch.from_numpy(p), torch.from_numpy(t), indexes=torch.from_numpy(i))
        out[name] = _np(m.compute())
        out[f"{name}_stats"] = m.sync_stats
        out[f"{name}_local_rows"] = sum(len(v) for v in m.preds)
    # no rank holds a row: the ragged sync still runs in step, and every state stays empty
    empty = M.RetrievalMAP(device="cpu")
    empty.sync()
    out["all_empty"] = [len(getattr(empty, k)) for k in ("indexes", "preds", "target")] + [empty.sync_stats["collectives"]]
    empty.unsync()
    return out


def scenario_sketches(rank):
    ids = click_like()
    part = ids[rank::WORLD]
    out = {}
    for quant_on in ("1", "0"):
        os.environ["METRICS_TPU_QUANT_SYNC"] = quant_on
        mc = M.MetricCollection(
            [M.CountMinHeavyHitters(device="cpu"), M.HyperLogLog(precision=12, device="cpu")],
            sync_precision="int8", compute_groups=False,
        )
        for i in range(0, part.size, 4096):
            mc.update(torch.from_numpy(part[i:i + 4096]))
        with mc.sync_context():
            out[f"countmin{quant_on}"] = _np(mc["CountMinHeavyHitters"].value)
            out[f"hll{quant_on}"] = _np(mc["HyperLogLog"].value)
        out[f"local_countmin{quant_on}"] = _np(mc["CountMinHeavyHitters"].value)
        out[f"wire{quant_on}"] = mc.sync_stats
    os.environ.pop("METRICS_TPU_QUANT_SYNC")
    return out


def scenario_collective_fault(rank):
    """The ``collective`` fault on every rank's first attempt: retried, no
    degrade. Then with no retries: every rank degrades in the same
    collective to its local state, and the count says so."""
    from metrics_tpu_torch import faults

    out = {}
    m = M.SumMetric(device="cpu")
    m.update(torch.tensor(float(rank + 1)))
    with faults.inject("collective", count=1) as spec:
        out["retried"] = float(m.compute())
        out["fired"] = spec.fired
    out["degrades_after_retry"] = resilience.degrades()
    os.environ["METRICS_TPU_COLLECTIVE_RETRIES"] = "0"
    m2 = M.SumMetric(device="cpu")
    m2.update(torch.tensor(float(rank + 1)))
    with faults.inject("collective", count=1):
        out["local_only"] = float(m2.compute())
    out["degrades"] = resilience.degrades()
    os.environ.pop("METRICS_TPU_COLLECTIVE_RETRIES")
    # a metric over an explicit group clones (the copy shares the group) and the copy syncs over it
    g = M.SumMetric(device="cpu", process_group=dist.group.WORLD)
    g.update(torch.tensor(float(rank)))
    out["clone_synced"] = float(g.clone().compute())
    out["degrades"] = resilience.degrades()
    return out


def scenario_deadline(rank):
    """A group whose own timeout (its deadline) falls in an uneven gather:
    rank 0 comes on time, the others later than the timeout. Every rank's
    gather fails in the backend and degrades to its local rows; the group is
    then broken, so a metric synced over it degrades with no collective
    issued, while the default group still syncs in full."""
    grp = dist.new_group(timeout=datetime.timedelta(seconds=DEADLINE_S))
    env = ProcessEnv(grp)
    if rank:
        time.sleep(2 * DEADLINE_S)
    out = {"gather": [g.tolist() for g in env.all_gather(torch.arange(rank + 1, dtype=torch.float32))]}
    out["broken"] = resilience.group_broken(grp)
    out["gather_degrades"] = resilience.degrades()
    late = M.CatMetric(device="cpu", process_group=grp)
    late.update(torch.arange(rank + 2, dtype=torch.float32))
    out["cat"] = _np(late.compute()).tolist()
    out["degrades"] = resilience.degrades()
    world = M.SumMetric(device="cpu")
    world.update(torch.tensor(float(rank + 1)))
    out["world"] = float(world.compute())
    out["world_broken"] = resilience.group_broken()
    return out


def _double_sum(x):
    return x.sum(0) * 2


class TorchReductions(M.Metric):
    """A state of every reduction: sum, mean, max (int32 and bool), min,
    cat (a list), None and a callable."""

    full_state_update = True

    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("fsum", torch.zeros(6), dist_reduce_fx="sum")
        self.add_state("fmean", torch.zeros(3), dist_reduce_fx="mean")
        self.add_state("imax", torch.zeros(4, dtype=torch.int32), dist_reduce_fx="max")
        self.add_state("fmin", torch.full((3,), 1e9), dist_reduce_fx="min")
        self.add_state("flag", torch.tensor(False), dist_reduce_fx="max")
        self.add_state("vals", [], dist_reduce_fx="cat")
        self.add_state("raw", torch.zeros(2), dist_reduce_fx=None)
        self.add_state("twice", torch.zeros(3), dist_reduce_fx=_double_sum)

    def update(self, x):
        self.fsum = self.fsum + x[:6]
        self.fmean = self.fmean + x[6:9]
        self.imax = torch.maximum(self.imax, (x[:4] * 100).to(torch.int32))
        self.fmin = torch.minimum(self.fmin, x[:3])
        self.flag = self.flag | (x > 0.97).any()
        self.vals.append(x[:4])
        self.raw = self.raw + x[:2]
        self.twice = self.twice + x[6:9]

    def compute(self):
        return self.fsum.sum()


def reduction_batches(rank):
    return [np.random.RandomState(100 * rank + s).rand(12).astype(np.float32) for s in range(2)]


def scenario_reductions(rank):
    out = {}
    for fused in ("1", "0"):
        os.environ["METRICS_TPU_FUSED_SYNC"] = fused
        m = TorchReductions()
        for b in reduction_batches(rank):
            m.update(torch.from_numpy(b))
        m.sync()
        out[fused] = {k: ([_np(v) for v in getattr(m, k)] if isinstance(getattr(m, k), list) else _np(getattr(m, k)))
                      for k in m._defaults}
        out[f"stats{fused}"] = m.sync_stats
        m.unsync()
    os.environ.pop("METRICS_TPU_FUSED_SYNC")
    return out


REGRESSION_SPLIT = (0, 1, 45, 135, 200)  # rows by rank: uneven, rank 0 holds one row
REGRESSION_BATCH = 32


def regression_like(seed=3):
    """200 rows of a 1-D prediction and target (Pearson) and of a 3-output one (R2), split by rank."""
    rng = np.random.RandomState(seed)
    n = REGRESSION_SPLIT[-1]
    preds = rng.randn(n).astype(np.float32)
    target = (0.6 * preds + 0.8 * rng.randn(n)).astype(np.float32)
    preds3 = rng.randn(n, 3).astype(np.float32)
    target3 = (preds3 * np.float32([1.0, 0.5, -0.3]) + rng.randn(n, 3)).astype(np.float32)
    return preds, target, preds3, target3


def regression_batches(rank):
    """Rank ``rank``'s rows in updates of ``REGRESSION_BATCH``: ``(preds, target, preds3, target3)`` each."""
    lo, hi = REGRESSION_SPLIT[rank], REGRESSION_SPLIT[rank + 1]
    data = regression_like()
    return [tuple(x[i:min(i + REGRESSION_BATCH, hi)] for x in data) for i in range(lo, hi, REGRESSION_BATCH)]


def regression_metrics(mod, **dev):
    return {"pearson": mod.PearsonCorrCoef(**dev),
            "r2": mod.R2Score(num_outputs=3, multioutput="variance_weighted", **dev)}


def scenario_regression(rank):
    out = {}
    for fused in ("1", "0"):
        os.environ["METRICS_TPU_FUSED_SYNC"] = fused
        metrics = regression_metrics(M, device="cpu")
        for p, t, p3, t3 in regression_batches(rank):
            metrics["pearson"].update(torch.from_numpy(p), torch.from_numpy(t))
            metrics["r2"].update(torch.from_numpy(p3), torch.from_numpy(t3))
        for key, m in metrics.items():
            out[f"{key}{fused}"] = _np(m.compute())
            m.sync()
            out[f"{key}_state{fused}"] = {k: _np(getattr(m, k)) for k in m._defaults}
            m.unsync()
    os.environ.pop("METRICS_TPU_FUSED_SYNC")
    return out


WINDOW_TICKS, WINDOW_ROWS = 7, (4, 10, 16, 22)  # every rank ticks in step, each on its own batch size
WINDOW_KW = {"window": 8, "slide": 2}  # four buckets: one a rank under shard_state


def window_batches(rank):
    """Rank ``rank``'s ticks: ``WINDOW_ROWS[rank]`` rows each, from its own part of the scores."""
    preds, target = imagenet_like()
    lo, b = rank * ROWS, WINDOW_ROWS[rank]
    return [(preds[lo + i * b: lo + (i + 1) * b], target[lo + i * b: lo + (i + 1) * b]) for i in range(WINDOW_TICKS)]


def scenario_window(rank):
    out = {}
    for jit in (False, True):
        w = M.SlidingWindow(M.Accuracy(num_classes=CLASSES, average="macro", device="cpu"), shard_state="world",
                            jit_update=jit, **WINDOW_KW)
        for p, t in window_batches(rank):
            w.update(torch.from_numpy(p), torch.from_numpy(t))
        local = {k: _np(v) for k, v in w.state().items()}
        synced = w.pure_sync(w.state())
        out[f"synced{int(jit)}"] = {k: _np(v) for k, v in synced.items()}
        out[f"assembled{int(jit)}"] = {k: _np(v) for k, v in w.assemble_sharded(synced).items()}
        out[f"value_sharded{int(jit)}"] = _np(w.pure_compute_sharded(synced))
        # the stateful compute syncs whole (the ring unsharded), reads the poisoned cache and rebuilds it
        out[f"compute{int(jit)}"] = _np(w.compute())
        out[f"local_kept{int(jit)}"] = all(np.array_equal(_np(getattr(w, k)), v) for k, v in local.items())
        out[f"stats{int(jit)}"] = w.sync_stats
    return out


SCENARIOS = {
    "reductions": scenario_reductions,
    "classification": scenario_classification,
    "sharded": scenario_sharded,
    "retrieval": scenario_retrieval,
    "sketches": scenario_sketches,
    "collective_fault": scenario_collective_fault,
    "deadline": scenario_deadline,
    "regression": scenario_regression,
    "window": scenario_window,
}


def _worker(rank, init, scenario, backend, results):
    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=WORLD,
                                timeout=datetime.timedelta(seconds=JOIN_S))
        try:
            out = SCENARIOS[scenario](rank)
            out["backend"] = dist.get_backend()
            out["degrades_end"] = resilience.degrades()
            results.put((rank, out, None))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 -- sent to the test, which fails with it
        results.put((rank, None, traceback.format_exc()))


def run_world(scenario, tmp_path, backend="gloo"):
    """The scenario on four ranks of a ``backend`` group (None: torch's
    default, no backend argument); their results by rank. Fails (and kills
    the workers) on a worker's error or after ``JOIN_S`` seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = "file://" + str(tmp_path / f"rendezvous-{scenario}")
    procs = [ctx.Process(target=_worker, args=(r, init, scenario, backend, results), daemon=True) for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    outs, errors = {}, []
    try:
        while len(outs) + len(errors) < WORLD:
            try:
                rank, out, err = results.get(timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                pytest.fail(f"{scenario}: the ranks did not finish within {JOIN_S} s ({sorted(outs)} did)")
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
            else:
                outs[rank] = out
        assert not errors, "\n".join(errors)
        for p in procs:
            p.join(max(0.1, deadline - time.monotonic()))
            assert not p.is_alive() and p.exitcode == 0, f"{scenario}: a worker did not exit cleanly"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    for out in outs.values():
        assert out["degrades_end"] == (out.get("degrades") or {}), "a collective or the engine degraded"
    return [outs[r] for r in range(WORLD)]


# ----------------------------------------------------------------- tests
def _jax_collection_values(preds, target):
    """The JAX package's collection, updated a shard a device and synced by
    ``pure_sync`` inside ``shard_map`` over four devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    import metrics_tpu as J
    from metrics_tpu._compat import shard_map

    jmc = J.MetricCollection(
        [
            J.Accuracy(num_classes=CLASSES, average="macro"),
            J.Precision(num_classes=CLASSES, average="macro"),
            J.F1Score(num_classes=CLASSES, average="macro"),
            J.HammingDistance(),
            J.ConfusionMatrix(num_classes=CLASSES, update_method="matmul"),
            J.CohenKappa(num_classes=CLASSES, weights="quadratic", update_method="matmul"),
            J.JaccardIndex(num_classes=CLASSES, update_method="matmul"),
        ],
        prefix="val_",
        compute_groups=False,
    )
    init = jmc.state()
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("r",))
    steps = ROWS // BATCH
    p = jnp.asarray(preds.reshape(WORLD, steps, BATCH, CLASSES))
    t = jnp.asarray(target.reshape(WORLD, steps, BATCH).astype(np.int32))

    def worker(state, p, t):
        for s in range(steps):
            state = jmc.pure_update(state, p[0, s], t[0, s])
        return jmc.pure_compute(jmc.pure_sync(state, "r"))

    run = jax.jit(shard_map(worker, mesh=mesh, in_specs=(jax.tree_util.tree_map(lambda _: P(), init), P("r"), P("r")),
                            out_specs=P(), check_vma=False))
    return {k: np.asarray(v) for k, v in run(init, p, t).items()}


def _assert_close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    if np.issubdtype(b.dtype, np.floating):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0, err_msg=what)
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


def test_every_reduction_on_four_ranks(tmp_path):
    """ProcessEnv's native sum, max and min, its gather-and-mean, bools on
    the wire, list, None and callable reductions, bucketed and per-leaf,
    against the JAX package's ``pure_sync`` over four devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from metrics_tpu._compat import shard_map
    from metrics_tpu.metric import Metric as JaxMetric

    class JaxReductions(JaxMetric):
        full_state_update = True

        def __init__(self):
            super().__init__()
            self.add_state("fsum", jnp.zeros(6, jnp.float32), dist_reduce_fx="sum")
            self.add_state("fmean", jnp.zeros(3, jnp.float32), dist_reduce_fx="mean")
            self.add_state("imax", jnp.zeros(4, jnp.int32), dist_reduce_fx="max")
            self.add_state("fmin", jnp.full((3,), 1e9, jnp.float32), dist_reduce_fx="min")
            self.add_state("flag", jnp.asarray(False), dist_reduce_fx="max")
            self.add_state("vals", [], dist_reduce_fx="cat")
            self.add_state("raw", jnp.zeros(2, jnp.float32), dist_reduce_fx=None)
            self.add_state("twice", jnp.zeros(3, jnp.float32), dist_reduce_fx=_double_sum)

        def update(self, x):
            self.fsum = self.fsum + x[:6]
            self.fmean = self.fmean + x[6:9]
            self.imax = jnp.maximum(self.imax, (x[:4] * 100).astype(jnp.int32))
            self.fmin = jnp.minimum(self.fmin, x[:3])
            self.flag = jnp.logical_or(self.flag, jnp.any(x > 0.97))
            self.vals.append(x[:4])
            self.raw = self.raw + x[:2]
            self.twice = self.twice + x[6:9]

        def compute(self):
            return self.fsum.sum()

    outs = run_world("reductions", tmp_path)
    jm = JaxReductions()
    data = jnp.asarray(np.stack([np.stack(reduction_batches(r)) for r in range(WORLD)]))
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("r",))

    def worker(x):
        state = jm.default_state()
        for s in range(x.shape[1]):
            state = jm.pure_update(state, x[0, s])
        return jm.pure_sync(state, "r")

    jax_state = jax.jit(shard_map(worker, mesh=mesh, in_specs=P("r"), out_specs=P(), check_vma=False))(data)
    for r, out in enumerate(outs):
        for fused in ("1", "0"):
            for k, j in jax_state.items():
                t = out[fused][k]
                if isinstance(j, list):
                    assert len(t) == len(j), k
                    for a, b in zip(t, j):
                        _assert_close(a, b, f"rank {r} fused={fused} {k}")
                else:
                    assert t.shape == np.shape(j), f"{k}: {t.shape} vs {np.shape(j)}"
                    _assert_close(t, j, f"rank {r} fused={fused} {k}")
        # bucketed: f32 sum, f32 mean, int32 max (the bool crosses with it on the int32 wire), f32 min
        assert out["stats1"]["buckets"] == 4 and out["stats0"]["buckets"] == 0
        assert out["stats1"]["collectives"] < out["stats0"]["collectives"]


def test_classification_collection_on_four_ranks(tmp_path):
    outs = run_world("classification", tmp_path)
    preds, target = imagenet_like()
    whole = collection()
    for i in range(0, WORLD * ROWS, BATCH):
        whole.update(torch.from_numpy(preds[i:i + BATCH]), torch.from_numpy(target[i:i + BATCH]))
    one_process = _np(whole.compute())
    jax_values = _jax_collection_values(preds, target)
    assert outs[0]["values1"].keys() == one_process.keys() == jax_values.keys()
    for r, out in enumerate(outs):
        for k in one_process:
            # integer states: the synced values are the one-process ones, bit for bit, fused or per-leaf
            np.testing.assert_array_equal(out["values1"][k], one_process[k], err_msg=f"rank {r} {k}")
            np.testing.assert_array_equal(out["values0"][k], out["values1"][k], err_msg=f"rank {r} {k}")
            _assert_close(out["values1"][k], jax_values[k], f"rank {r} {k} against JAX")
        # one bucket pass (int32 sums of the three leaders) against a collective a member's leaf
        assert out["buckets1"] == out["collectives1"] == 1
        assert out["buckets0"] == 0 and out["collectives0"] > out["collectives1"]
        lo = r * ROWS
        local = M.Accuracy(num_classes=CLASSES, average="macro", device="cpu")
        local.update(torch.from_numpy(preds[lo:lo + ROWS]), torch.from_numpy(target[lo:lo + ROWS]))
        np.testing.assert_array_equal(out["local_tp1"], _np(local.tp))
        # synced values: the same on every rank, through the engine as eager
        np.testing.assert_array_equal(out["acc_jit1"], out["acc_jit0"])
        np.testing.assert_array_equal(out["acc_jit1"], outs[0]["acc_jit0"])


def test_sharded_confusion_matrix_on_four_ranks(tmp_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    import metrics_tpu as J
    from metrics_tpu._compat import shard_map

    outs = run_world("sharded", tmp_path)
    _, target = imagenet_like()
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("r",))
    steps = ROWS // BATCH
    tt = target.reshape(WORLD, steps, BATCH)
    pp = tt[:, :, ::-1]
    full = np.zeros((SHARD_CLASSES, SHARD_CLASSES), np.int64)
    np.add.at(full, (target, pp.reshape(-1)), 1)
    for precision in (None, "int8"):
        jm = J.ConfusionMatrix(num_classes=SHARD_CLASSES, update_method="matmul", shard_state="r",
                               sync_precision=precision)
        init = jm.state()

        def worker(state, p, t):
            for s in range(steps):
                state = jm.pure_update(state, p[0, s], t[0, s])
            return jm.pure_sync(state, "r")["confmat"]

        run = jax.jit(shard_map(worker, mesh=mesh, in_specs=(jax.tree_util.tree_map(lambda _: P(), init), P("r"), P("r")),
                                out_specs=P("r"), check_vma=False))
        jax_shards = np.asarray(run(init, jnp.asarray(pp.astype(np.int32)), jnp.asarray(tt.astype(np.int32))))
        tag = precision or "full"
        rows = SHARD_CLASSES // WORLD
        for r, out in enumerate(outs):
            # each rank keeps its own rows of the reduced matrix: the JAX device's shard, bit for bit
            assert out[f"shard_{tag}"].shape == (rows, SHARD_CLASSES)
            np.testing.assert_array_equal(out[f"shard_{tag}"], jax_shards[r * rows:(r + 1) * rows])
            np.testing.assert_array_equal(out[f"assembled_{tag}"], jax_shards)
            np.testing.assert_array_equal(out[f"value_{tag}"], jax_shards)
            np.testing.assert_array_equal(out[f"compute_{tag}"], full)
            assert out[f"stats_{tag}"]["sharded_buckets"] == 1
        if precision is None:
            np.testing.assert_array_equal(jax_shards, full)  # a reduce-scatter of counts is exact


def _check_retrieval(outs):
    import jax.numpy as jnp

    import metrics_tpu as J

    rows, shards = retrieval_like()
    assert outs[3][f"{RETRIEVAL[0]}_local_rows"] == 0
    for name in RETRIEVAL:
        whole, jwhole = getattr(M, name)(device="cpu"), getattr(J, name)()
        for p, t, i in rows:
            whole.update(torch.from_numpy(p), torch.from_numpy(t), indexes=torch.from_numpy(i))
            jwhole.update(jnp.asarray(p), jnp.asarray(t), indexes=jnp.asarray(i))
        expected = float(whole.compute())
        np.testing.assert_allclose(expected, float(jwhole.compute()), rtol=RTOL)
        for r, out in enumerate(outs):
            np.testing.assert_allclose(float(out[name]), expected, rtol=RTOL, err_msg=f"rank {r} {name}")
            # the probe-free ragged protocol: one lengths gather and three data gathers, each a size exchange
            assert out[f"{name}_stats"]["collectives"] == 4
    for out in outs:
        assert out["all_empty"] == [0, 0, 0, 4]


def test_retrieval_with_an_empty_rank_on_four_ranks(tmp_path):
    _check_retrieval(run_world("retrieval", tmp_path))


def test_retrieval_on_a_group_made_with_no_backend_argument(tmp_path):
    """torch's default group (no backend named, ``get_backend`` reports no
    single one): ProcessEnv issues the same calls on the data's device, the
    uneven gathers' size exchanges included."""
    outs = run_world("retrieval", tmp_path, backend=None)
    assert all(out["backend"] != "gloo" for out in outs)
    _check_retrieval(outs)


def test_sketches_on_the_int8_wire_on_four_ranks(tmp_path):
    from metrics_tpu_torch import quant

    outs = run_world("sketches", tmp_path)
    ids = click_like()
    exact_cm = M.CountMinHeavyHitters(device="cpu")
    exact_hll = M.HyperLogLog(precision=12, device="cpu")
    exact_cm.update(torch.from_numpy(ids))
    exact_hll.update(torch.from_numpy(ids))
    locals_ = [out["local_countmin1"] for out in outs]
    # the up codec's bound, a block of 256 cells: each rank adds at most its block's largest count over 126
    blocks = np.stack([np.abs(v.reshape(-1, 256)).max(axis=1) / 126 for v in locals_]).sum(axis=0)
    bound = np.repeat(blocks, 256).reshape(exact_cm.value.shape)
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["hll1"], _np(exact_hll.value))  # bit planes: the union, exact
        np.testing.assert_array_equal(out["hll0"], _np(exact_hll.value))
        np.testing.assert_array_equal(out["countmin0"], _np(exact_cm.value))  # the full-precision wire: exact
        assert np.all(out["countmin1"] >= _np(exact_cm.value))
        assert np.all(out["countmin1"] - _np(exact_cm.value) <= bound * (1 + 1e-6))
        np.testing.assert_array_equal(out["countmin1"], outs[0]["countmin1"])
        wire, logical = out["wire1"]["bytes_on_wire"], out["wire1"]["bytes_logical"]
        codec_cm = quant.QuantCodec("q8", rounding="up")
        assert wire == quant.bucket_wire_nbytes(4 * 1024, codec_cm) + quant.bucket_wire_nbytes(4096, quant.QuantCodec("pack", bits=5))
        assert logical == 4 * 1024 * 4 + 4096 * 4 and out["wire0"]["bytes_on_wire"] == logical


def test_collective_fault_retried_then_degraded_on_four_ranks(tmp_path):
    outs = run_world("collective_fault", tmp_path)
    for r, out in enumerate(outs):
        assert out["fired"] == 1 and out["retried"] == 10.0
        assert out["degrades_after_retry"] == {}
        assert out["local_only"] == float(r + 1)  # world-size-1 semantics for the failed sync
        assert out["clone_synced"] == 6.0
        assert out["degrades"] == {"collective": 1}


def test_deadline_in_an_uneven_gather_breaks_the_group_on_four_ranks(tmp_path):
    outs = run_world("deadline", tmp_path)
    for r, out in enumerate(outs):
        assert out["gather"] == [list(range(r + 1))]  # world-size-1 semantics: its own rows alone
        assert out["broken"] and out["gather_degrades"] == {"collective": 1}
        # the metric over the broken group is served locally, every collective it would issue counted, none issued
        assert out["cat"] == list(range(r + 2))
        assert out["degrades"]["collective"] > 1
        assert out["degrades"] == outs[0]["degrades"]
        assert out["world"] == 10.0 and not out["world_broken"]


def test_pearson_and_r2_on_four_uneven_ranks_equal_jax_pure_sync(tmp_path):
    """Pearson's moments stacked to (4, 1) by the gather and merged in rank
    order, and R2's summed states, on ranks of 1, 44, 90 and 65 rows, against
    the JAX package's ``pure_sync`` over four devices (each device's state
    made from its own rows first) and the port on all rows in one process.
    The ranks' synced states are bit-equal to each other; against the JAX
    package and the one-process run they agree to rtol 1e-5, atol 1e-6
    (float32 sums in another order)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    import metrics_tpu as J
    from metrics_tpu._compat import shard_map

    outs = run_world("regression", tmp_path)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("r",))
    jax_values, jax_states = {}, {}
    for key in ("pearson", "r2"):
        states = []
        for rank in range(WORLD):
            jm = regression_metrics(J)[key]
            for p, t, p3, t3 in regression_batches(rank):
                batch = (p, t) if key == "pearson" else (p3, t3)
                jm.update(*(jnp.asarray(x) for x in batch))
            states.append(jm.state())
        stacked = {k: jnp.stack([s[k] for s in states]) for k in states[0]}
        jm = regression_metrics(J)[key]

        def worker(st, jm=jm):
            synced = jm.pure_sync({k: v[0] for k, v in st.items()}, "r")
            return synced, jm.pure_compute(synced)

        synced, value = jax.jit(shard_map(worker, mesh=mesh, in_specs=(P("r"),), out_specs=P(),
                                          check_vma=False))(stacked)
        jax_states[key], jax_values[key] = synced, value
    assert jax_states["pearson"]["mean_x"].shape == (WORLD, 1)
    data = regression_like()
    alone = regression_metrics(M, device="cpu")
    alone["pearson"].update(torch.from_numpy(data[0]), torch.from_numpy(data[1]))
    alone["r2"].update(torch.from_numpy(data[2]), torch.from_numpy(data[3]))
    for r, out in enumerate(outs):
        for fused in ("1", "0"):
            for key in ("pearson", "r2"):
                for k, j in jax_states[key].items():
                    got = out[f"{key}_state{fused}"][k]
                    assert got.shape == np.shape(j) and got.dtype == np.asarray(j).dtype, (key, k, got.shape)
                    # every rank holds the same synced bits; the JAX states' float32 sums ran in another order
                    np.testing.assert_array_equal(got, outs[0][f"{key}_state{fused}"][k])
                    np.testing.assert_allclose(got, np.asarray(j), rtol=1e-5, atol=1e-6,
                                               err_msg=f"rank {r} fused={fused} {key}.{k}")
                np.testing.assert_allclose(out[f"{key}{fused}"], np.asarray(jax_values[key]), rtol=1e-5, atol=1e-6,
                                           err_msg=f"rank {r} fused={fused} {key}")
                np.testing.assert_allclose(out[f"{key}{fused}"], _np(alone[key].compute()), rtol=1e-5, atol=0,
                                           err_msg=f"rank {r} {key} against all rows in one process")


def test_sliding_window_on_four_uneven_ranks_equals_jax_pure_sync(tmp_path):
    """A ``SlidingWindow(Accuracy)`` on ranks of 4, 10, 16 and 22 rows a tick,
    its ring sharded over the world (``shard_state="world"``, one bucket a
    rank), synced by ``pure_sync``: each rank's ring shard and every other
    leaf equal the JAX package's ``pure_sync`` over four devices bit for bit,
    ``pfx_token`` poisoned to -1 on both; the read of the assembled state
    rebuilds the prefix and equals the JAX package's ``pure_compute_sharded``
    and the stateful ``compute`` (synced whole), engine and eager alike, and
    the local states come back after ``compute``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    import metrics_tpu as J
    from metrics_tpu._compat import shard_map
    from metrics_tpu.streaming import SlidingWindow

    outs = run_world("window", tmp_path)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("r",))
    states = []
    for rank in range(WORLD):
        jw = SlidingWindow(J.Accuracy(num_classes=CLASSES, average="macro"), shard_state="r", jit_update=False,
                           **WINDOW_KW)
        for p, t in window_batches(rank):
            jw.update(jnp.asarray(p), jnp.asarray(t.astype(np.int32)))
        states.append(jw.state())
    stacked = {k: jnp.stack([st[k] for st in states]) for k in states[0]}
    ring = [k for k in stacked if k.startswith("ring_")]

    def worker(st):
        return jw.pure_sync({k: v[0] for k, v in st.items()}, "r")

    synced = jax.jit(shard_map(worker, mesh=mesh, in_specs=(P("r"),),
                               out_specs={k: (P("r") if k in ring else P()) for k in stacked}, check_vma=False))(stacked)
    # the JAX package's named-axis sync gives its scalar states shape (1,) (``AxisEnv``'s atleast_1d), on which
    # its traced read cannot branch: its value is read eagerly from the scalars restored, as the port keeps them
    synced = {k: np.asarray(v).reshape(np.shape(jw._defaults[k])) if k not in ring else np.asarray(v)
              for k, v in synced.items()}
    value = jw.pure_compute({k: jnp.asarray(v) for k, v in synced.items()})
    assert int(synced["pfx_token"]) == -1
    for r, out in enumerate(outs):
        for jit in ("0", "1"):
            got = out[f"synced{jit}"]
            for k, ref in synced.items():
                if k in ring:
                    # this rank's bucket of the reduce-scattered ring
                    assert got[k].shape == (1,) + ref.shape[1:], (k, got[k].shape)
                    np.testing.assert_array_equal(got[k], ref[r:r + 1], err_msg=f"rank {r} {k}")
                    np.testing.assert_array_equal(out[f"assembled{jit}"][k], ref, err_msg=f"rank {r} {k} assembled")
                else:
                    assert got[k].dtype == ref.dtype, k
                    np.testing.assert_array_equal(got[k], ref, err_msg=f"rank {r} {k}")
            np.testing.assert_allclose(out[f"value_sharded{jit}"], np.asarray(value), rtol=RTOL, atol=0)
            np.testing.assert_array_equal(out[f"compute{jit}"], outs[0]["value_sharded0"])
            np.testing.assert_array_equal(out[f"value_sharded{jit}"], outs[0]["value_sharded0"])
            assert out[f"local_kept{jit}"]
            assert out[f"stats{jit}"]["sharded_buckets"] >= 1
