"""The port's pairwise functionals held against the JAX package on the CPU.

Built from ``tests/pairwise/test_pairwise.py``: cosine, euclidean, linear and
manhattan on ``x`` and ``y``, on ``x`` alone (``zero_diagonal`` defaults to
True there), ``zero_diagonal`` given either way, every reduction and the
input errors; also against float64 numpy. Tolerances:

* rtol 1e-5 and atol 1e-6 for cosine and manhattan (float32 sums in another
  order); linear is a dot product of unnormalised rows, so its atol is
  ``D * 2**-23 * |x_i| |y_j|`` element by element (two float32 dot products
  differ by at most that); euclidean computes ``|x|^2 + |y|^2 - 2 x.y``,
  which cancels near the diagonal, so its atol is ``sqrt((D + 2) * 2**-22 *
  (|x_i|^2 + |y_j|^2))``, growing with the squared norms, not the distance;
  the same bounds hold against the JAX package and against float64 numpy;
* bit-equal: the manhattan distance in row blocks against one block, the
  zeroed diagonals, and the reductions of an equal matrix.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional as jF
import metrics_tpu_torch.functional as tF
from metrics_tpu_torch.functional.pairwise import metrics as pairwise

FUNCTIONS = ("pairwise_cosine_similarity", "pairwise_euclidean_distance", "pairwise_linear_similarity",
             "pairwise_manhattan_distance")
RTOL, ATOL = 1e-5, 1e-6
N, M, D = 12, 8, 6


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _data(seed=5, n=N, m=M, d=D):
    rng = np.random.RandomState(seed)
    return rng.rand(n, d).astype(np.float32), rng.randn(m, d).astype(np.float32)


def _numpy(fn, x, y):
    """The float64 formula of each function."""
    x, y = x.astype(np.float64), y.astype(np.float64)
    if fn == "pairwise_cosine_similarity":
        return (x / np.linalg.norm(x, axis=1, keepdims=True)) @ (y / np.linalg.norm(y, axis=1, keepdims=True)).T
    if fn == "pairwise_euclidean_distance":
        return np.sqrt(((x[:, None, :] - y[None, :, :]) ** 2).sum(-1))
    if fn == "pairwise_linear_similarity":
        return x @ y.T
    return np.abs(x[:, None, :] - y[None, :, :]).sum(-1)


def _atol(fn, x, y):
    """The element-wise absolute tolerance of ``fn`` (see the module docstring)."""
    d = x.shape[1]
    nx, ny = np.linalg.norm(x.astype(np.float64), axis=1)[:, None], np.linalg.norm(y.astype(np.float64), axis=1)[None]
    if fn == "pairwise_linear_similarity":
        return d * 2.0**-23 * nx * ny + ATOL
    if fn == "pairwise_euclidean_distance":
        # two float32 evaluations of |x|^2 + |y|^2 - 2 x.y differ by at most (d + 2) 2**-22 (|x|^2 + |y|^2),
        # and |sqrt(a) - sqrt(b)| <= sqrt(|a - b|)
        return np.sqrt((d + 2) * 2.0**-22 * (nx**2 + ny**2)) + ATOL
    return ATOL


def _assert_close(ref, got, atol):
    """``got`` float32 of ``ref``'s shape (the JAX package's float32, or float64 numpy), within the bound."""
    ref, got = np.asarray(ref), got.numpy()
    assert got.dtype == np.float32 and ref.dtype in (np.float32, np.float64) and got.shape == ref.shape
    np.testing.assert_array_less(np.abs(got.astype(np.float64) - ref), atol + RTOL * np.abs(ref) + 1e-30)


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_x_and_y_equal_jax_and_numpy(fn):
    x, y = _data()
    got = getattr(tF, fn)(_t(x), _t(y))
    atol = _atol(fn, x, y)
    _assert_close(getattr(jF, fn)(jnp.asarray(x), jnp.asarray(y)), got, atol)
    _assert_close(_numpy(fn, x, y), got, atol)


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_x_alone_zeroes_the_diagonal_like_jax(fn):
    x, _ = _data(seed=6)
    got = getattr(tF, fn)(_t(x))
    assert torch.equal(torch.diagonal(got), torch.zeros(N))
    expected = _numpy(fn, x, x)
    np.fill_diagonal(expected, 0)
    atol = _atol(fn, x, x)
    _assert_close(getattr(jF, fn)(jnp.asarray(x)), got, atol)
    _assert_close(expected, got, atol)


@pytest.mark.parametrize("fn", FUNCTIONS)
@pytest.mark.parametrize("with_y,zero_diagonal", [(True, True), (False, False)])
def test_explicit_zero_diagonal_equals_jax(fn, with_y, zero_diagonal):
    x, y = _data(seed=7)
    y = x[:M] + 0.5 if with_y else None
    args_j = (jnp.asarray(x),) + ((jnp.asarray(y),) if with_y else ())
    args_t = (_t(x),) + ((_t(y),) if with_y else ())
    got = getattr(tF, fn)(*args_t, zero_diagonal=zero_diagonal)
    ref = getattr(jF, fn)(*args_j, zero_diagonal=zero_diagonal)
    if zero_diagonal:
        assert torch.equal(torch.diagonal(got), torch.zeros(M))
    _assert_close(ref, got, _atol(fn, x, x if y is None else y))


@pytest.mark.parametrize("fn", FUNCTIONS)
@pytest.mark.parametrize("reduction", ["mean", "sum", None, "none"])
def test_reductions_equal_jax(fn, reduction):
    x, y = _data(seed=8)
    got = getattr(tF, fn)(_t(x), _t(y), reduction=reduction)
    full = getattr(tF, fn)(_t(x), _t(y))
    want = {"mean": full.mean(-1), "sum": full.sum(-1)}.get(reduction, full)
    assert torch.equal(got, want)
    atol = _atol(fn, x, y)
    if reduction in ("mean", "sum"):
        atol = (atol if np.ndim(atol) == 0 else atol.sum(-1)) + RTOL * np.abs(full.numpy()).sum(-1)
    _assert_close(getattr(jF, fn)(jnp.asarray(x), jnp.asarray(y), reduction=reduction), got, atol)


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_input_errors_equal_jax(fn):
    x, y = _data()
    cases = [
        ((x[0],), {}),  # x not 2-D
        ((x, y[:, :3]), {}),  # y's width differs
        ((x, y[0]), {}),  # y not 2-D
        ((x, y), {"reduction": "max"}),
    ]
    for args, kwargs in cases:
        with pytest.raises(ValueError) as jax_err:
            getattr(jF, fn)(*(jnp.asarray(a) for a in args), **kwargs)
        with pytest.raises(ValueError) as torch_err:
            getattr(tF, fn)(*(_t(a) for a in args), **kwargs)
        assert str(torch_err.value) == str(jax_err.value)


def test_manhattan_in_row_blocks_is_bit_equal_to_one_block(monkeypatch):
    """Blocks of 5 rows (the last of 2) against the whole ``(N, M, D)`` broadcast."""
    x, y = _data(seed=9, n=17, m=11, d=7)
    whole = tF.pairwise_manhattan_distance(_t(x), _t(y))
    monkeypatch.setattr(pairwise, "MANHATTAN_BLOCK_BYTES", 5 * 11 * 7 * 4)
    assert pairwise.manhattan_block_rows(11, 7, 4) == 5
    assert torch.equal(tF.pairwise_manhattan_distance(_t(x), _t(y)), whole)
    assert torch.equal(tF.pairwise_manhattan_distance(_t(x)), pairwise.pairwise_manhattan_distance(_t(x)))
    monkeypatch.setattr(pairwise, "MANHATTAN_BLOCK_BYTES", 1)
    assert pairwise.manhattan_block_rows(11, 7, 4) == 1
    assert torch.equal(tF.pairwise_manhattan_distance(_t(x), _t(y)), whole)


def test_manhattan_block_rows_keep_the_broadcast_under_a_gibibyte():
    # MS MARCO's dense shard: 8,192 passages of 768 floats
    rows = pairwise.manhattan_block_rows(8192, 768, 4)
    assert rows * 8192 * 768 * 4 <= 1 << 30 < (rows + 1) * 8192 * 768 * 4
    assert pairwise.manhattan_block_rows(1 << 20, 1024, 4) == 1
