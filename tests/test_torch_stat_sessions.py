"""The ``stat_scores`` kernel's session axis: its plain version against ``jax.vmap``.

The service's stacked update counts S sessions' rows in one launch; the JAX
package gets the same counts from ``jax.vmap`` of ``stat_scores_counts``
(its production scatter, and its Pallas kernel in interpret mode). The plain
version must equal both exactly, on labels in range for the Pallas kernel
(whose one-hot tiles drop any other label) and on labels out of range at
both ends for the scatter, whose wrap-or-drop rule holds within each
session's own 3C cells. The kernel itself is held against the plain version
on the card (``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.ops.stat_scores import stat_scores_counts as jax_counts
from metrics_tpu_torch.functional.classification.stat_scores import (
    _fast_multiclass_stat_scores,
)
from metrics_tpu_torch.ops import stat_scores_counts, stat_scores_counts_sessions
from metrics_tpu_torch.ops.stat_scores import stat_scores_sessions_plan


def _inputs(seed, sessions, rows, c, lo, hi):
    rng = np.random.RandomState(seed)
    target = rng.randint(lo, hi, (sessions, rows)).astype(np.int32)
    pred = np.where(rng.rand(sessions, rows) < 0.5, target, rng.randint(lo, hi, (sessions, rows))).astype(np.int32)
    w = (rng.rand(sessions, rows) < 0.8).astype(np.int32)
    correct = (target == pred) & (w > 0)
    return target, pred, correct, w


def _vmapped(target, pred, correct, w, c, force_pallas):
    out = jax.vmap(lambda t, p, k, x: jax_counts(t, p, k, x, c, force_pallas=force_pallas))(
        jnp.asarray(target), jnp.asarray(pred), jnp.asarray(correct), jnp.asarray(w))
    return np.stack([np.asarray(x) for x in out], axis=1)


def _ours(target, pred, correct, w, c):
    return stat_scores_counts_sessions(*(torch.from_numpy(x) for x in (target, pred, correct, w)), c).numpy()


@pytest.mark.parametrize("sessions", [1, 7, 64])
@pytest.mark.parametrize("c", [1, 2, 10, 1000])
def test_plain_equals_vmap_of_the_scatter_with_labels_out_of_range(sessions, c):
    # labels in [-3C - 2, 3C + 2): below -3C and at or past 3C are dropped, [-3C, 0) wraps
    args = _inputs(sessions * 31 + c, sessions, 32, c, -3 * c - 2, 3 * c + 2)
    got = _ours(*args, c)
    assert got.dtype == np.int32 and got.shape == (sessions, 3, c)
    np.testing.assert_array_equal(got, _vmapped(*args, c, force_pallas=False))


@pytest.mark.parametrize("sessions", [1, 7, 64])
@pytest.mark.parametrize("c", [1, 2, 10, 1000])
def test_plain_equals_vmap_of_the_pallas_kernel_in_range(sessions, c):
    args = _inputs(sessions * 17 + c, sessions, 32, c, 0, c)
    np.testing.assert_array_equal(_ours(*args, c), _vmapped(*args, c, force_pallas=True))


def test_each_session_equals_the_one_batch_counts():
    c = 10
    args = _inputs(5, 9, 40, c, -3 * c - 5, 3 * c + 5)
    got = _ours(*args, c)
    for s in range(9):
        one = stat_scores_counts(*(torch.from_numpy(np.ascontiguousarray(x[s])) for x in args), c)
        np.testing.assert_array_equal(got[s], np.stack([t.numpy() for t in one]))


def test_a_nan_row_never_reaches_a_neighbour_session():
    """A NaN score row predicts class C (tp[0] of its own session), and labels
    in [3C, 6C) of session 0 would be session 1's cells in one flat scatter:
    both stay inside session 0."""
    c, rows = 4, 8
    rng = np.random.RandomState(6)
    scores = rng.rand(2, rows, c).astype(np.float32)
    scores[0, 3] = np.nan
    target = rng.randint(0, c, (2, rows)).astype(np.int32)
    target[0, 5] = 3 * c + 1
    mask = torch.ones(2, rows, dtype=torch.bool)
    tp, fp, tn, fn = _fast_multiclass_stat_scores(torch.from_numpy(scores), torch.from_numpy(target), "macro", None,
                                                  mask)
    alone = _fast_multiclass_stat_scores(torch.from_numpy(scores[1:]), torch.from_numpy(target[1:]), "macro", None,
                                         mask[1:])
    for a, b in zip((tp, fp, tn, fn), alone):
        assert torch.equal(a[1], b[0])
    pred = torch.from_numpy(scores).reshape(-1, c)
    assert int(torch.isnan(pred).any(dim=1).sum()) == 1


@pytest.mark.parametrize("reduce", ["micro", "macro"])
@pytest.mark.parametrize("ignore_index", [None, 2])
def test_stacked_stat_scores_equal_the_masked_batch_path_per_session(reduce, ignore_index):
    c, sessions, rows = 6, 5, 16
    rng = np.random.RandomState(7)
    scores = torch.from_numpy(rng.rand(sessions, rows, c).astype(np.float32))
    scores[2, 4] = float("nan")
    target = torch.from_numpy(rng.randint(0, c, (sessions, rows)))
    n_valid = torch.tensor([16, 3, 0, 9, 1])
    mask = torch.arange(rows)[None, :] < n_valid[:, None]
    got = _fast_multiclass_stat_scores(scores, target, reduce, ignore_index, mask)
    for s in range(sessions):
        want = _fast_multiclass_stat_scores(scores[s], target[s], reduce, ignore_index, mask[s])
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == torch.int32 and torch.equal(a[s], b)


def test_the_session_plan_and_the_checks():
    assert stat_scores_sessions_plan(1024, 64, 1000, 232448) == ("sessions", 1024, 256)
    assert stat_scores_sessions_plan(4, 64, 20000, 232448)[0] == "sessions-global"
    t = torch.zeros(3, 4, dtype=torch.int32)
    ok = (t, t, t.bool(), t)
    stat_scores_counts_sessions(*ok, 5)
    with pytest.raises(TypeError, match="int32"):
        stat_scores_counts_sessions(t.long(), t, t.bool(), t, 5)
    with pytest.raises(ValueError, match=r"\(S, B\)"):
        stat_scores_counts_sessions(t[0], t[0], t[0].bool(), t[0], 5)
    with pytest.raises(ValueError, match="shape"):
        stat_scores_counts_sessions(t, t[:2], t.bool(), t, 5)
    with pytest.raises(ValueError, match="contiguous"):
        stat_scores_counts_sessions(t.t(), t.t(), t.t().bool(), t.t(), 5)
    with pytest.raises(ValueError, match="positive"):
        stat_scores_counts_sessions(*ok, 0)
    assert stat_scores_counts_sessions(*(x[:, :0].contiguous() for x in ok), 5).abs().sum() == 0
