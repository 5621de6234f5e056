"""KernelInceptionDistance and InceptionScore in the port against the JAX
package, on the CPU (their draws: ``tests/test_torch_jax_random.py``).

What must be bit-equal is: the KID subsets under one ``np.random`` seed and
under ``compute_rng_key``, the buffers' writes and merges, and IS's
``split_count`` with and without ``assignment_rng_key``. Values (float32
kernel sums, softmaxes and logs in another order) are held at rtol 1e-5, the
states of sums at 1e-5 of their scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.image.kid as jkid
from metrics_tpu.image import InceptionScore as JIS
from metrics_tpu.image import KernelInceptionDistance as JKID
from metrics_tpu_torch.image import InceptionScore as TIS
from metrics_tpu_torch.image import KernelInceptionDistance as TKID
from metrics_tpu_torch.image.kid import _subset_indices
from metrics_tpu_torch.interop import load_jax_state_dict, to_jax_state_dict
from metrics_tpu_torch.utilities.checks import tracing
from tests.test_torch_image_fid import _features, _jnp, _t, fid_weights  # noqa: F401 -- a fixture

RTOL = 1e-5


def _words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


# ------------------------------------------------------------------ KID
def _recorded_permutations(monkeypatch):
    """Wrap ``np.random.permutation`` (the same stream) to record its draws."""
    drawn, permutation = [], np.random.permutation

    def recording(n):
        out = permutation(n)
        drawn.append(out.copy())
        return out

    monkeypatch.setattr(np.random, "permutation", recording)
    return drawn


def _kid_batches(seed, d=16, sizes=(30, 25, 45)):
    out = []
    for i, n in enumerate(sizes):
        out.append((_features(seed + i, n, d), True))
        out.append((_features(seed + 50 + i, n, d, shift=0.2, scale=1.1), False))
    return out


def _fill(metric, batches, to):
    for x, real in batches:
        metric.update(to(x), real=real)
    return metric


def _close(got, want, rtol=RTOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=rtol, atol=rtol * 1e-2)


@pytest.mark.parametrize("kwargs", [{}, {"feature_dim": 16, "max_samples": 128}], ids=["list", "buffer"])
def test_kid_subsets_and_values_match_jax(monkeypatch, kwargs):
    """One numpy seed: the same subsets (recorded draws, bit for bit), the
    same mean and std; the buffer path's value is the list path's bits."""
    batches = _kid_batches(3)
    kw = dict(subsets=7, subset_size=40, **kwargs)
    jm, tm = _fill(JKID(**kw), batches, _jnp), _fill(TKID(**kw, device="cpu"), batches, _t)
    drawn = _recorded_permutations(monkeypatch)
    np.random.seed(5)
    want = jm.compute()
    np.random.seed(5)
    got = tm.compute()
    half = len(drawn) // 2
    assert half == 2 * kw["subsets"] and all(np.array_equal(a, b) for a, b in zip(drawn[:half], drawn[half:]))
    _close(got, want)
    if kwargs:
        lst = _fill(TKID(subsets=7, subset_size=40, device="cpu"), batches, _t)
        np.random.seed(5)
        assert all(torch.equal(a, b) for a, b in zip(lst.compute(), got))


def test_kid_in_graph_subsets_are_jax_top_k_of_jax_uniform():
    """``compute_rng_key``'s draw: the indices of ``lax.top_k`` over
    ``jax.random.uniform`` priorities masked to the valid rows, bit for bit,
    over 200 keys and masks (ties included: a mask with few valid rows)."""
    rng = np.random.RandomState(8)
    for i in range(200):
        n, valid = 64, int(rng.randint(20, 65))
        mask = np.arange(n) < valid
        k = int(rng.randint(1, valid + 1))
        key = jax.random.PRNGKey(int(rng.randint(0, 2**31 - 1)))
        priorities = jnp.where(jnp.asarray(mask), jax.random.uniform(key, (n,)), -jnp.inf)
        want = np.asarray(jax.lax.top_k(priorities, k)[1])
        got = _subset_indices(torch.from_numpy(_words(key)), torch.from_numpy(mask), k)
        assert np.array_equal(got.numpy(), want), i
    # ties between valid rows: equal priorities keep the lower index first
    tied = torch.tensor([0.5, 0.25, 0.5, 0.5, -np.inf])
    assert torch.sort(tied, descending=True, stable=True).indices[:3].tolist() == \
        np.asarray(jax.lax.top_k(jnp.asarray(tied.numpy()), 3)[1]).tolist()


@pytest.mark.parametrize("stacked", [False, True], ids=["local", "synced-stack"])
def test_kid_in_graph_compute_matches_jax(stacked):
    batches = _kid_batches(13)
    kw = dict(subsets=6, subset_size=30, feature_dim=16, max_samples=128, compute_rng_key=1234)
    jm, tm = _fill(JKID(**kw), batches, _jnp), _fill(TKID(**kw, device="cpu"), batches, _t)
    if stacked:  # a dist-synced state: (world, capacity, D) buffers and (world,) counts
        for prefix in ("real", "fake"):
            buf, cnt = np.asarray(getattr(jm, f"{prefix}_buffer")), np.asarray(getattr(jm, f"{prefix}_count"))
            stack, counts = np.stack([buf, buf[::-1] * 0 + buf]), np.stack([cnt, cnt])
            object.__setattr__(jm, f"{prefix}_buffer", jnp.asarray(stack))
            object.__setattr__(jm, f"{prefix}_count", jnp.asarray(counts))
            object.__setattr__(tm, f"{prefix}_buffer", torch.from_numpy(stack))
            object.__setattr__(tm, f"{prefix}_count", torch.from_numpy(counts))
    _close(tm.compute(), jm.compute())
    with tracing():
        traced = tm._compute_impl()
    assert all(torch.equal(a, b) for a, b in zip(traced, tm.compute()))


def test_kid_buffer_writes_merges_and_overflows_match_jax():
    """The contiguous writes (bit-equal buffers), the eager overflow raise
    on update and on merge (the same messages), NaN-poison inside a program
    (the port's ``tracing()``, the JAX package's ``jit``), and the merge's
    compaction bit-equal to the JAX package's ``pure_merge``."""
    kw = dict(feature_dim=4, max_samples=10)
    jm, tm = JKID(**kw), TKID(**kw, device="cpu")
    a, b, c = _features(1, 4, 4), _features(2, 3, 4), _features(3, 5, 4)
    for x in (a, b):
        jm.update(_jnp(x), real=True)
        tm.update(_t(x), real=True)
    assert np.array_equal(tm.real_buffer.numpy(), np.asarray(jm.real_buffer)) and int(tm.real_count) == 7
    with pytest.raises(ValueError) as port:
        tm.update(_t(c), real=True)
    with pytest.raises(ValueError) as ref:
        jm.update(_jnp(c), real=True)
    assert str(port.value) == str(ref.value)

    j_state, t_state = jm.state(), tm.state()
    with tracing():
        t_poisoned = tm.pure_update(t_state, _t(c), real=True)
    j_poisoned = jax.jit(lambda s, x: jm.pure_update(s, x, real=True))(j_state, _jnp(c))
    assert bool(torch.isnan(t_poisoned["real_buffer"]).all()) and bool(jnp.isnan(j_poisoned["real_buffer"]).all())
    assert int(t_poisoned["real_count"]) == int(j_poisoned["real_count"]) == 12

    jo, to = JKID(**kw), TKID(**kw, device="cpu")
    jo.update(_jnp(b), real=True)
    to.update(_t(b), real=True)
    jo.update(_jnp(a), real=False)
    to.update(_t(a), real=False)
    j_merged, t_merged = jm.pure_merge(jm.state(), jo.state()), tm.pure_merge(tm.state(), to.state())
    for key in j_merged:
        assert np.array_equal(t_merged[key].numpy(), np.asarray(j_merged[key])), key
    with pytest.raises(ValueError) as port:
        tm.pure_merge(t_merged, tm.state())
    with pytest.raises(ValueError) as ref:
        jm.pure_merge(j_merged, jm.state())
    assert str(port.value) == str(ref.value)
    with tracing():
        t_over = tm.pure_merge(t_merged, tm.state())
    j_over = jax.jit(jm.pure_merge)(j_merged, jm.state())
    assert bool(torch.isnan(t_over["real_buffer"]).all()) and bool(jnp.isnan(j_over["real_buffer"]).all())


def test_kid_engine_update_is_the_eager_bits():
    batches = _kid_batches(21)
    kw = dict(subsets=3, subset_size=20, feature_dim=16, max_samples=128)
    eager = _fill(TKID(**kw, device="cpu"), batches, _t)
    engine = _fill(TKID(**kw, jit_update=True, device="cpu"), batches, _t)
    for key in eager._defaults:
        assert torch.equal(getattr(engine, key), getattr(eager, key)), key
    np.random.seed(3)
    want = eager.compute()
    np.random.seed(3)
    assert all(torch.equal(a, b) for a, b in zip(engine.compute(), want))


def test_kid_checkpoints_cross_and_reset_keeps_the_real_side(monkeypatch):
    batches = _kid_batches(31)
    kw = dict(subsets=4, subset_size=30, feature_dim=16, max_samples=128, reset_real_features=False)
    jm = _fill(JKID(**kw), batches[:2], _jnp)
    tm = TKID(**kw, device="cpu")
    jm.persistent(True)
    tm.persistent(True)
    load_jax_state_dict(tm, jm.state_dict())
    back = JKID(**kw)
    back.load_state_dict(to_jax_state_dict(tm))
    for m, to in ((jm, _jnp), (tm, _t), (back, _jnp)):
        _fill(m, batches[2:], to)
    for m in (jm, tm, back):
        m.reset()
        _fill(m, [batches[-1]], _t if m is tm else _jnp)
    values = []
    for m in (jm, tm, back):
        np.random.seed(9)
        values.append(m.compute())
    _close(values[1], values[0])
    _close(values[2], values[0])


@pytest.mark.parametrize("kwargs", [
    {"subsets": 0}, {"subset_size": -1}, {"degree": 1.5}, {"gamma": 2}, {"coef": 1}, {"feature_dim": 3},
    {"feature_dim": 3, "max_samples": 0}, {"compute_rng_key": 1}, {"feature_dim": 2, "max_samples": 5,
                                                                    "subset_size": 6, "compute_rng_key": 1},
    {"feature_dim": 2, "max_samples": 5, "compute_rng_key": 1.5}, {"reset_real_features": None},
], ids=lambda kw: "-".join(kw))
def test_kid_constructor_errors_match_jax(kwargs):
    with pytest.raises(ValueError) as port:
        TKID(**kwargs, device="cpu")
    with pytest.raises(ValueError) as ref:
        JKID(**kwargs)
    assert str(port.value).split(" got ")[0] == str(ref.value).split(" got ")[0]


def test_kid_compute_errors_match_jax():
    for kw in ({"subset_size": 50}, {"subset_size": 50, "feature_dim": 16, "max_samples": 64},
               {"subset_size": 50, "feature_dim": 16, "max_samples": 64, "compute_rng_key": 0}):
        jm, tm = _fill(JKID(**kw), _kid_batches(1, sizes=(30,)), _jnp), _fill(TKID(**kw, device="cpu"),
                                                                             _kid_batches(1, sizes=(30,)), _t)
        with pytest.raises(ValueError) as port:
            tm.compute()
        with pytest.raises(ValueError) as ref:
            jm.compute()
        assert str(port.value) == str(ref.value)
    tm = _fill(TKID(subset_size=5, feature_dim=16, max_samples=64, device="cpu"), _kid_batches(1, sizes=(30,)), _t)
    with tracing(), pytest.raises(ValueError, match="needs `compute_rng_key=`"):
        tm._compute_impl()


def test_kid_functions_match_jax():
    x, y = _features(4, 20, 6), _features(5, 20, 6, shift=0.5)
    for degree, gamma, coef in ((3, None, 1.0), (2, 0.5, 2.0)):
        np.testing.assert_allclose(
            jkid.poly_kernel(_jnp(x), _jnp(y), degree, gamma, coef),
            __import__("metrics_tpu_torch.image.kid", fromlist=["poly_kernel"]).poly_kernel(
                _t(x), _t(y), degree, gamma, coef).numpy(), rtol=RTOL)
    from metrics_tpu_torch.image.kid import poly_mmd

    np.testing.assert_allclose(float(poly_mmd(_t(x), _t(y))), float(jkid.poly_mmd(_jnp(x), _jnp(y))), rtol=RTOL)


# ------------------------------------------------------------------ IS
def _logits(seed, n, k=12):
    return (np.random.RandomState(seed).randn(n, k) * 2.0).astype(np.float32)


@pytest.mark.parametrize("n,splits", [(25, 10), (40, 4), (7, 1)])
def test_is_list_path_matches_jax(n, splits):
    """The shuffle under one numpy seed and torch.chunk's sizes (25 rows in
    10 splits: nine chunks)."""
    x = _logits(n, n)
    jm, tm = JIS(splits=splits), TIS(splits=splits, device="cpu")
    jm.update(_jnp(x[: n // 2]))
    jm.update(_jnp(x[n // 2:]))
    tm.update(_t(x[: n // 2]))
    tm.update(_t(x[n // 2:]))
    np.random.seed(17)
    want = jm.compute()
    np.random.seed(17)
    _close(tm.compute(), want)


@pytest.mark.parametrize("key", [None, 7, "raw"], ids=["round-robin", "seed", "raw-key"])
def test_is_streaming_matches_jax(key):
    """``split_count`` bit-equal (round-robin, or ``fold_in`` + ``randint``
    keyed by the samples seen), the sums within 1e-5 of their scale, the
    mean and std at rtol 1e-5."""
    jkey = tkey = key
    if key == "raw":
        jkey = jax.random.PRNGKey(99)
        tkey = np.asarray(jkey)
    kw = dict(splits=5, num_classes=12)
    jm, tm = JIS(**kw, assignment_rng_key=jkey), TIS(**kw, assignment_rng_key=tkey, device="cpu")
    for i, n in enumerate((9, 16, 3, 30)):
        x = _logits(40 + i, n)
        jm.update(_jnp(x))
        tm.update(_t(x))
    assert np.array_equal(tm.split_count.numpy(), np.asarray(jm.split_count))
    assert int(tm.num_seen) == int(jm.num_seen) == 58 and tm.num_seen.dtype == torch.int32
    for name in ("prob_sum", "plogp_sum"):
        want = np.asarray(getattr(jm, name))
        np.testing.assert_allclose(getattr(tm, name).numpy(), want, atol=RTOL * np.abs(want).max())
    _close(tm.compute(), jm.compute())


def test_is_streaming_engine_and_checkpoints():
    """The engine's update (``fold_in`` on the device count inside the
    program) is the eager update's bits; a streaming state crosses both ways."""
    kw = dict(splits=4, num_classes=12, assignment_rng_key=3)
    eager, engine = TIS(**kw, device="cpu"), TIS(**kw, jit_update=True, device="cpu")
    xs = [_logits(60 + i, 8) for i in range(4)]
    for x in xs:
        eager.update(_t(x))
        engine.update(_t(x))
    for name in eager._defaults:
        assert torch.equal(getattr(engine, name), getattr(eager, name)), name
    jm = JIS(**kw)
    for x in xs[:2]:
        jm.update(_jnp(x))
    jm.persistent(True)
    tm = TIS(**kw, device="cpu")
    tm.persistent(True)
    load_jax_state_dict(tm, jm.state_dict())
    back = JIS(**kw)
    back.load_state_dict(to_jax_state_dict(tm))
    for x in xs[2:]:
        jm.update(_jnp(x))
        tm.update(_t(x))
        back.update(_jnp(x))
    assert np.array_equal(tm.split_count.numpy(), np.asarray(jm.split_count))
    assert np.array_equal(np.asarray(back.split_count), np.asarray(jm.split_count))
    _close(tm.compute(), jm.compute())


@pytest.mark.parametrize("kwargs", [
    {"splits": 0}, {"num_classes": 0}, {"assignment_rng_key": 1}, {"num_classes": 3, "assignment_rng_key": "k"},
], ids=lambda kw: "-".join(kw))
def test_is_constructor_errors_match_jax(kwargs):
    with pytest.raises(ValueError) as port:
        TIS(**kwargs, device="cpu")
    with pytest.raises(ValueError) as ref:
        JIS(**kwargs)
    assert str(port.value).split(" got ")[0] == str(ref.value).split(" got ")[0]


def test_is_logits_shape_error_matches_jax():
    jm, tm = JIS(num_classes=5), TIS(num_classes=5, device="cpu")
    with pytest.raises(ValueError) as port:
        tm.update(_t(_logits(1, 4, k=6)))
    with pytest.raises(ValueError) as ref:
        jm.update(_jnp(_logits(1, 4, k=6)))
    assert str(port.value) == str(ref.value)


# ------------------------------------------------------------------ bundled net
def test_bundled_net_kid_and_is_match_jax(fid_weights):
    """KID at the 64 tap and IS on ``logits_unbiased`` (the default) through
    each package's own InceptionV3, the same weights and uint8 images."""
    rng = np.random.RandomState(51)
    real = (rng.rand(20, 75, 75, 3) * 255).astype(np.uint8)
    fake = (rng.rand(20, 75, 75, 3) * 180).astype(np.uint8)
    jk = JKID(feature=64, weights_path=fid_weights, subsets=5, subset_size=16)
    tk = TKID(feature=64, weights_path=fid_weights, subsets=5, subset_size=16, device="cpu")
    ji = JIS(weights_path=fid_weights, splits=3)
    ti = TIS(weights_path=fid_weights, splits=3, device="cpu")
    for m, to in ((jk, _jnp), (tk, _t)):
        m.update(to(real), real=True)
        m.update(to(fake), real=False)
    for m, to in ((ji, _jnp), (ti, _t)):
        m.update(to(fake))
    np.testing.assert_allclose(torch.cat(ti.features).numpy(), np.concatenate(ji.features), atol=1e-4)
    np.random.seed(2)
    want_k, want_i = jk.compute(), ji.compute()
    np.random.seed(2)
    got_k, got_i = tk.compute(), ti.compute()
    _close(got_i, want_i)
    _close(got_k, want_k, rtol=1e-4)
