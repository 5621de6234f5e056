"""Kill and recover the port's journaled service at each crash point.

For every crash point of :data:`metrics_tpu_torch.faults.CRASH_POINTS` a
subprocess running a fixed request stream against a journaled
``MetricsService`` (the worker below, under ``__main__``) is SIGKILLed at
that instruction; a fresh subprocess ``recover()``s (checkpoint plus the
sequence-fenced journal tail) and finishes the stream. Its ``state_digest``
and values must equal an uncrashed twin's, and the JAX package's
``MetricsService`` fed the same stream. Checkpoints written by either
package restore in the other, to equal digests.

The six points' runs start together (one wave of kills, one of recoveries),
so the matrix costs about two subprocess lifetimes.

Worker usage: ``python tests/test_torch_serve_crash.py {run|recover} WORKDIR {torch|jax}``
"""
import json
import os
import signal
import subprocess
import sys

import numpy as np

N_OPS = 30
N_SESSIONS = 5
BATCH, CLASSES = 16, 8
# the probe at which each point fires: mid-stream, with earlier checkpoints and segments on disk (as the JAX
# package's tests/bases/test_crash_recovery.py picks them)
CRASH_NTH = {
    "post-journal": 10,
    "mid-journal-append": 10,
    "mid-flush": 3,
    "mid-checkpoint": 2,
    "mid-truncate": 2,
    # keep-last-1 ladder: the 2nd GC unlink happens inside the 3rd periodic checkpoint, mid-stream
    "mid-history-gc": 2,
}


def ops_list():
    """The fixed op stream; op i journals as sequence i + 1."""
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
    rng = np.random.RandomState(1000 + i)
    target = rng.randint(0, CLASSES, BATCH)
    preds = rng.rand(BATCH, CLASSES).astype(np.float32)
    preds[np.arange(BATCH), target] += rng.rand(BATCH).astype(np.float32)
    return preds, target


def worker(phase, root, package):
    """Run the stream (from op 0, or after ``recover()`` from the journal's
    high-water mark) and print the digest as the last line."""
    if package == "torch":
        import torch

        from metrics_tpu_torch import Accuracy
        from metrics_tpu_torch.serve import HistoryPolicy, MetricsService

        template = Accuracy(num_classes=CLASSES, average="macro", device="cpu")
        as_array = torch.from_numpy

        def value_bits(v):
            return v.numpy().tobytes().hex()
    else:
        import jax.numpy as jnp

        from metrics_tpu import Accuracy
        from metrics_tpu.serve import HistoryPolicy, MetricsService

        template = Accuracy(num_classes=CLASSES, average="macro")
        as_array = jnp.asarray

        def value_bits(v):
            return np.asarray(v).tobytes().hex()

    svc = MetricsService(template, journal_dir=os.path.join(root, "wal"), checkpoint_dir=os.path.join(root, "ckpt"),
                         checkpoint_every=2, history=HistoryPolicy(keep_last=1))
    start_seq = 0
    if phase == "recover":
        svc.recover()
        start_seq = svc.journal.last_seq
    closed = set()
    for idx, op in enumerate(ops_list()):
        seq = idx + 1
        if seq <= start_seq:  # durable before the kill, applied by the replay
            if op[0] == "close":
                closed.add(op[1])
            elif op[0] == "update":
                closed.discard(op[1])
            continue
        if op[0] == "update":
            _, name, i = op
            if name in closed:
                svc.open_session(name)
                closed.discard(name)
            svc.submit(name, *(as_array(x) for x in batch_for(i)))
        elif op[0] == "close":
            svc.close_session(op[1])
            closed.add(op[1])
        elif op[0] == "reset":
            svc.reset_session(op[1])
        if idx % 4 == 3:
            svc.flush()
    svc.drain()
    values = {name: value_bits(v) for name, v in sorted(svc.compute_all().items())}
    print(json.dumps({"digest": svc.state_digest(), "values": values, "last_seq": svc.journal.last_seq}))


if __name__ == "__main__":
    worker(*sys.argv[1:4])
    sys.exit(0)


import pytest  # noqa: E402 - the worker above needs no pytest

from metrics_tpu_torch import faults  # noqa: E402

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_SELF = os.path.abspath(__file__)


def _env(crash=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO
    env["JAX_PLATFORMS"] = "cpu"
    env["METRICS_TPU_WAL_SEGMENT_BYTES"] = "4096"  # the stream spans several segments, so truncation unlinks
    for var in ("METRICS_TPU_INJECT_FAULT", "METRICS_TPU_CRASH", "METRICS_TPU_AOT_CACHE"):
        env.pop(var, None)
    if crash is not None:
        env["METRICS_TPU_CRASH"] = crash
    return env


def _start(phase, workdir, package="torch", crash=None):
    return subprocess.Popen([sys.executable, _SELF, phase, str(workdir), package], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_env(crash), cwd=_REPO)


def _finish(proc, timeout=240):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return proc.returncode, out, err


def _digest(rc, out, err):
    assert rc == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def matrix(tmp_path_factory):
    """The twins of both packages and every point's kill, all at once; then
    every point's recovery, all at once."""
    root = tmp_path_factory.mktemp("crash")
    twins = {pkg: _start("run", root / f"twin-{pkg}", pkg) for pkg in ("torch", "jax")}
    crashed = {p: _start("run", root / p, crash=f"{p}:{n}") for p, n in CRASH_NTH.items()}
    killed = {p: _finish(proc) for p, proc in crashed.items()}
    recovered = {p: _start("recover", root / p) for p in CRASH_NTH}
    return {
        "twins": {pkg: _digest(*_finish(proc)) for pkg, proc in twins.items()},
        "killed": killed,
        "recovered": {p: _finish(proc) for p, proc in recovered.items()},
    }


def test_twins_of_both_packages_agree(matrix):
    port, jax_twin = matrix["twins"]["torch"], matrix["twins"]["jax"]
    assert port["digest"] == jax_twin["digest"]
    assert port["last_seq"] == jax_twin["last_seq"] == N_OPS
    assert port["values"].keys() == jax_twin["values"].keys()
    for name, bits in port["values"].items():
        got = np.frombuffer(bytes.fromhex(bits), np.float32)
        want = np.frombuffer(bytes.fromhex(jax_twin["values"][name]), np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("point", list(CRASH_NTH))
def test_kill_and_recover_equals_the_twin(point, matrix):
    rc, out, err = matrix["killed"][point]
    # the armed probe SIGKILLs the worker: no exception, no digest
    assert rc in (-signal.SIGKILL, 128 + signal.SIGKILL), f"{point} did not kill the worker (rc={rc})\n{err[-3000:]}"
    assert not out.strip()
    got = _digest(*matrix["recovered"][point])
    twin = matrix["twins"]["torch"]
    assert got["digest"] == twin["digest"] == matrix["twins"]["jax"]["digest"], point
    assert got["values"] == twin["values"] and got["last_seq"] == twin["last_seq"]


def test_crash_points_registry_is_closed():
    assert set(CRASH_NTH) == set(faults.CRASH_POINTS)


def test_checkpoints_cross_packages_both_ways(tmp_path):
    """A checkpoint of the JAX service restores in the port's and the port's
    in the JAX package's, to equal digests, and both go on serving alike."""
    import jax.numpy as jnp
    import torch

    import metrics_tpu
    import metrics_tpu_torch
    from metrics_tpu.serve import MetricsService as JService
    from metrics_tpu_torch.serve import MetricsService

    port = MetricsService(metrics_tpu_torch.Accuracy(num_classes=CLASSES, average="macro", device="cpu"))
    jax_svc = JService(metrics_tpu.Accuracy(num_classes=CLASSES, average="macro"))
    for i in range(12):
        preds, target = batch_for(i)
        port.submit(f"s{i % 5}", torch.from_numpy(preds), torch.from_numpy(target))
        jax_svc.submit(f"s{i % 5}", jnp.asarray(preds), jnp.asarray(target))
    port.drain()
    jax_svc.drain()
    port_path = port.checkpoint(str(tmp_path / "port.npz"))
    jax_path = jax_svc.checkpoint(str(tmp_path / "jax.npz"))
    into_port = MetricsService(metrics_tpu_torch.Accuracy(num_classes=CLASSES, average="macro", device="cpu"))
    into_jax = JService(metrics_tpu.Accuracy(num_classes=CLASSES, average="macro"))
    assert into_port.restore(jax_path) and into_jax.restore(port_path)
    assert into_port.state_digest() == into_jax.state_digest() == port.state_digest()
    preds, target = batch_for(99)
    into_port.update("s0", torch.from_numpy(preds), torch.from_numpy(target))
    into_jax.update("s0", jnp.asarray(preds), jnp.asarray(target))
    assert into_port.state_digest() == into_jax.state_digest()
    np.testing.assert_allclose(into_port.compute("s0").numpy(), np.asarray(into_jax.compute("s0")), rtol=1e-6)
