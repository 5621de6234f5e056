"""Kill one shard of the port's fabric at each crash point; a peer recovers it.

One OS process per shard, as the fabric runs across hosts: each worker (the
``__main__`` below) runs the same op stream and executes only the ops whose
session the :class:`~metrics_tpu_torch.fabric.HashRing` gives its shard, on a
journaled ``MetricsService`` with a keep-last-1 checkpoint ladder (so the
``mid-history-gc`` point fires) and, with ``METRICS_TPU_REPLICATE=1``, a hot
standby it ships its journal to after every op. For every crash point of
:data:`metrics_tpu_torch.faults.CRASH_POINTS` shard 0 is SIGKILLed there; then
the peer's side of failover runs in a fresh process: fence the dead shard's
journal one epoch higher, ``recover()``, finish the slice. The union of the
recovered partition and the surviving shard's must equal the uncrashed twin
fleet's digest, and the JAX package's fleet fed the same stream, and the
zombie's epoch must be refused. All the runs (the twins of both packages and
every point's kill) start together, then all the recoveries: two waves.

Worker usage: ``python tests/test_torch_fabric_crash.py {run|recover} WORKDIR SHARD NSHARDS {torch|jax}``
"""
import json
import os
import signal
import subprocess
import sys

import numpy as np

N_OPS = 44
N_SESSIONS = 6
BATCH, CLASSES = 16, 8
VICTIM, SURVIVOR, NSHARDS = 0, 1, 2
# the probe at which each point fires on shard 0's slice (the ring gives each shard three sessions): mid-stream,
# as the JAX package's tests/bases/test_crash_recovery.py tunes its fabric matrix
CRASH_NTH = {
    "post-journal": 8,
    "mid-journal-append": 8,
    "mid-flush": 2,
    "mid-checkpoint": 2,
    "mid-truncate": 2,
    "mid-history-gc": 1,
}


def ops_list():
    """The fixed global op stream: every shard sees the same list."""
    ops = []
    for i in range(N_OPS):
        if i == 12:
            ops.append(("close", "s1"))
        elif i == 20:
            ops.append(("reset", "s3"))
        else:
            ops.append(("update", f"s{i % N_SESSIONS}", i))
    return ops


def batch_for(i):
    rng = np.random.RandomState(2000 + i)
    return rng.randint(0, CLASSES, BATCH), rng.randint(0, CLASSES, BATCH)


def worker(phase, root, shard, nshards, package):
    """Run this shard's slice (from its first op, or after ``recover()`` from
    the journal's high-water mark) and print its partition's digest."""
    shard, nshards = int(shard), int(nshards)
    if package == "torch":
        import torch

        from metrics_tpu_torch import Accuracy, wal
        from metrics_tpu_torch.fabric import HashRing
        from metrics_tpu_torch.serve import HistoryPolicy, MetricsService

        template = lambda: Accuracy(task="multiclass", num_classes=CLASSES, device="cpu")  # noqa: E731
        as_array = torch.from_numpy

        def bits(v):
            return v.numpy().tobytes().hex()
    else:
        import jax.numpy as jnp

        from metrics_tpu import Accuracy, wal
        from metrics_tpu.fabric import HashRing
        from metrics_tpu.serve import HistoryPolicy, MetricsService

        template = lambda: Accuracy(task="multiclass", num_classes=CLASSES)  # noqa: E731
        as_array = jnp.asarray

        def bits(v):
            return np.asarray(v).tobytes().hex()

    ring = HashRing(list(range(nshards)))
    journal_dir = os.path.join(root, f"shard-{shard:02d}", "wal")
    # run: the first epoch; recover: one higher. Building the service at read_epoch() + 1 fences the directory
    # before any replay, so the takeover is fence-then-recover by construction.
    epoch = wal.read_epoch(journal_dir) + 1
    svc = MetricsService(
        template(), journal_dir=journal_dir, checkpoint_dir=os.path.join(root, f"shard-{shard:02d}", "ckpt"),
        checkpoint_every=2, history=HistoryPolicy(keep_last=1), shard_id=shard, rid_offset=shard,
        rid_stride=nshards, epoch=epoch,
    )
    start_seq = 0
    if phase == "recover":
        svc.recover()
        start_seq = svc.journal.last_seq
    standby = None
    if phase == "run" and os.environ.get("METRICS_TPU_REPLICATE") == "1":
        standby = wal.StandbyReplica(
            MetricsService(template(), shard_id=shard, rid_offset=shard, rid_stride=nshards), source_shard=shard)

    def ship():
        # every op: the cursor stays ahead of the periodic checkpoint's truncation
        if standby is not None:
            standby.apply(svc.journal.stream_since(standby.cursor), svc.replication_floor())

    closed = set()
    local = 0  # this shard's ops journal as seq 1, 2, ...: the resume cursor
    for op in ops_list():
        name = op[1]
        if ring.owner(name) != shard:
            continue
        local += 1
        if local <= start_seq:  # durable before the kill, applied by the replay
            if op[0] == "close":
                closed.add(name)
            elif op[0] == "update":
                closed.discard(name)
            continue
        if op[0] == "update":
            if name in closed:
                svc.open_session(name)
                closed.discard(name)
            svc.submit(name, *(as_array(x) for x in batch_for(op[2])))
        elif op[0] == "close":
            svc.close_session(name)
            closed.add(name)
        elif op[0] == "reset":
            svc.reset_session(name)
        ship()
        if local % 4 == 0:
            svc.flush()
            ship()
    svc.drain()
    ship()
    if standby is not None and standby.digest() != svc.state_digest():
        raise SystemExit(f"the standby diverged from shard {shard}'s primary")
    values = {name: bits(v) for name, v in sorted(svc.compute_all().items())}
    print(json.dumps({"digest": svc.state_digest(), "values": values, "last_seq": svc.journal.last_seq,
                      "epoch": svc.epoch, "shard": shard}))


if __name__ == "__main__":
    worker(*sys.argv[1:6])
    sys.exit(0)


import pytest  # noqa: E402 - the worker above needs no pytest

from metrics_tpu_torch import faults, wal  # noqa: E402

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_SELF = os.path.abspath(__file__)


def _env(crash=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO
    env["JAX_PLATFORMS"] = "cpu"
    env["METRICS_TPU_REPLICATE"] = "1"  # shipping interleaves with every armed point
    env["METRICS_TPU_WAL_SEGMENT_BYTES"] = "4096"  # several segments, so truncation unlinks
    for var in ("METRICS_TPU_INJECT_FAULT", "METRICS_TPU_CRASH", "METRICS_TPU_AOT_CACHE"):
        env.pop(var, None)
    if crash is not None:
        env["METRICS_TPU_CRASH"] = crash
    return env


def _start(phase, workdir, shard, package="torch", crash=None):
    return subprocess.Popen([sys.executable, _SELF, phase, str(workdir), str(shard), str(NSHARDS), package],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(crash), cwd=_REPO)


def _finish(proc, timeout=240):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return proc.returncode, out, err


def _result(rc, out, err):
    assert rc == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def matrix(tmp_path_factory):
    """The twin fleets of both packages and every point's kill of shard 0, all at once; then every recovery."""
    root = tmp_path_factory.mktemp("fabric-crash")
    twins = {(pkg, k): _start("run", root / f"twin-{pkg}", k, pkg) for pkg in ("torch", "jax") for k in range(NSHARDS)}
    crashed = {p: _start("run", root / p, VICTIM, crash=f"{p}:{n}") for p, n in CRASH_NTH.items()}
    killed = {p: _finish(proc) for p, proc in crashed.items()}
    recovered = {p: _start("recover", root / p, VICTIM) for p in CRASH_NTH}
    return {
        "root": root,
        "twins": {key: _result(*_finish(proc)) for key, proc in twins.items()},
        "killed": killed,
        "recovered": {p: _finish(proc) for p, proc in recovered.items()},
    }


def test_twin_fleets_of_both_packages_agree(matrix):
    twins = matrix["twins"]
    for k in range(NSHARDS):
        port, ref = twins[("torch", k)], twins[("jax", k)]
        assert port["digest"] == ref["digest"] and port["last_seq"] == ref["last_seq"]
        assert port["values"].keys() == ref["values"].keys()
        for name, bits in port["values"].items():
            np.testing.assert_allclose(np.frombuffer(bytes.fromhex(bits), np.float32),
                                       np.frombuffer(bytes.fromhex(ref["values"][name]), np.float32), rtol=1e-6)
    names = [set(twins[("torch", k)]["values"]) for k in range(NSHARDS)]
    assert not names[0] & names[1] and names[0] and names[1]


@pytest.mark.parametrize("point", list(CRASH_NTH))
def test_kill_a_shard_and_fail_over_equals_the_twin_fleet(point, matrix):
    rc, out, err = matrix["killed"][point]
    assert rc in (-signal.SIGKILL, 128 + signal.SIGKILL), f"{point} did not kill shard 0 (rc={rc})\n{err[-3000:]}"
    assert not out.strip()
    got = _result(*matrix["recovered"][point])
    twins = matrix["twins"]
    assert got["digest"] == twins[("torch", VICTIM)]["digest"] == twins[("jax", VICTIM)]["digest"], point
    assert got["values"] == twins[("torch", VICTIM)]["values"] and got["last_seq"] == twins[("torch", VICTIM)]["last_seq"]
    fleet = dict(got["values"], **twins[("torch", SURVIVOR)]["values"])
    twin_fleet = dict(twins[("torch", VICTIM)]["values"], **twins[("torch", SURVIVOR)]["values"])
    assert fleet == twin_fleet
    # the zombie is fenced out: reopening the journal at its old epoch is refused
    journal_dir = os.path.join(str(matrix["root"] / point), f"shard-{VICTIM:02d}", "wal")
    assert got["epoch"] == 2 and wal.read_epoch(journal_dir) == 2
    with pytest.raises(wal.StaleEpochError):
        wal.WriteAheadLog(journal_dir, epoch=1)


def test_fabric_crash_matrix_registry_is_closed():
    assert set(CRASH_NTH) == set(faults.CRASH_POINTS)
