"""FrechetInceptionDistance in the port against the JAX package, on the CPU:
the list and moment paths, ``feature_shift``, the three ``sqrtm_method``s,
Newton–Schulz's stopping step, the errors, ``reset_real_features``,
checkpoints both ways, the engines' programs and the bundled InceptionV3.

Tolerances: FID within 1e-4 of ``tr Σ₁ + tr Σ₂`` on the eigh path (the JAX
package's float32 covariances and eigensolvers against the port's float64),
and of scipy's float64 value on an ill-conditioned covariance; Newton–Schulz
within the JAX package's own 1e-2 relative of the exact value and the two
packages' iterates frozen at the same step, on float32 covariances and, with
the JAX package's x64 on, on the float64 ones the metric passes; the moment
states within 1e-5 of their scale (float32 sums in another order).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import metrics_tpu.image.fid as jfid  # noqa: E402
import metrics_tpu.image.inception_net as jnet  # noqa: E402
import metrics_tpu_torch.image.fid as tfid  # noqa: E402
from convert_inception_weights import convert_state_dict  # noqa: E402
from metrics_tpu.image import FrechetInceptionDistance as JFID  # noqa: E402
from metrics_tpu_torch.image import FrechetInceptionDistance as TFID  # noqa: E402
from metrics_tpu_torch.interop import load_jax_state_dict, to_jax_state_dict  # noqa: E402
from metrics_tpu_torch.utilities.checks import tracing  # noqa: E402
from tests.image.test_weight_conversion import _make_inception_state  # noqa: E402

FID_TOL = 1e-4  # of tr(S1) + tr(S2)
NS_RTOL = 1e-2
STATE_RTOL = 1e-5


def _features(seed, n, d, shift=0.0, scale=1.0):
    rng = np.random.RandomState(seed)
    mix = rng.randn(d, d) / np.sqrt(d)
    return ((rng.randn(n, d) @ mix) * scale + shift).astype(np.float32)


def _fid_tol(real, fake):
    return FID_TOL * (np.trace(np.cov(real, rowvar=False)) + np.trace(np.cov(fake, rowvar=False)))


def _fill(metric, batches, to):
    for x, real in batches:
        metric.update(to(x), real=real)
    return metric


def _jnp(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _batches(seed, d, sizes=(40, 33, 50), shift=0.0):
    out = []
    for i, n in enumerate(sizes):
        out.append((_features(seed + i, n, d, shift=shift), True))
        out.append((_features(seed + 100 + i, n, d, shift=shift + 0.3, scale=1.2), False))
    return out


def _sides(batches):
    real = np.concatenate([x for x, r in batches if r])
    fake = np.concatenate([x for x, r in batches if not r])
    return real, fake


@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("kwargs", [{}, {"feature_dim": True}, {"feature_dim": True, "feature_shift": 3.0}],
                         ids=["list", "moments", "moments-shift"])
def test_fid_matches_jax(d, kwargs):
    kwargs = {k: (d if v is True else v) for k, v in kwargs.items()}
    batches = _batches(10 * d, d, shift=3.0 if "feature_shift" in kwargs else 0.0)
    jm, tm = _fill(JFID(**kwargs), batches, _jnp), _fill(TFID(**kwargs, device="cpu"), batches, _t)
    if "feature_dim" in kwargs:
        for key in jm._defaults:
            want = np.asarray(getattr(jm, key))
            got = getattr(tm, key).numpy()
            assert got.dtype == want.dtype, key
            np.testing.assert_allclose(got, want, rtol=0, atol=STATE_RTOL * max(np.abs(want).max(), 1.0))
    got, want = float(tm.compute()), float(jm.compute())
    np.testing.assert_allclose(got, want, atol=_fid_tol(*_sides(batches)))


@pytest.mark.parametrize("method", ["eigh", "eigh_host", "newton_schulz"])
def test_sqrtm_methods_match_jax(method):
    batches = _batches(7, 16, sizes=(64, 64))
    jm = _fill(JFID(sqrtm_method=method), batches, _jnp)
    tm = _fill(TFID(sqrtm_method=method, device="cpu"), batches, _t)
    tol = {"rtol": NS_RTOL} if method == "newton_schulz" else {"atol": _fid_tol(*_sides(batches))}
    np.testing.assert_allclose(float(tm.compute()), float(jm.compute()), **tol)


@pytest.mark.parametrize("method", ["eigh", "eigh_host", "newton_schulz"])
def test_ill_conditioned_fid_holds_float64(method):
    """A covariance of rank 64 in 256 dimensions with a shifted, rectified
    mean (as ReLU features are): the port's float64 compute within 1e-4 of
    the traces of scipy's float64 value, where the JAX package's float32
    square root (x64 off) misses it by more, the fault the port does not copy."""
    from scipy import linalg

    rng = np.random.RandomState(0)
    mix = rng.randn(64, 256) / 8.0
    real = np.maximum(rng.randn(512, 64) @ mix + 3.0, 0).astype(np.float32)
    fake = np.maximum(rng.randn(512, 64) @ mix * 1.02 + 3.0, 0).astype(np.float32)
    r64, f64 = real.astype(np.float64), fake.astype(np.float64)
    s1, s2 = np.cov(r64, rowvar=False), np.cov(f64, rowvar=False)
    traces = np.trace(s1) + np.trace(s2)
    exact = ((r64.mean(0) - f64.mean(0)) ** 2).sum() + traces - 2 * np.trace(linalg.sqrtm(s1 @ s2).real)
    batches = [(real, True), (fake, False)]
    tm = _fill(TFID(sqrtm_method=method, device="cpu"), batches, _t)
    assert abs(float(tm.compute()) - exact) <= FID_TOL * traces
    jm = _fill(JFID(sqrtm_method="eigh"), batches, _jnp)
    assert abs(float(jm.compute()) - exact) > FID_TOL * traces


def _jax_newton_schulz(monkeypatch, s1, s2):
    """The JAX package's Newton–Schulz value and its loop's exit carry: the
    steps it ran and whether it froze (read from ``lax.while_loop``'s output)."""
    exits = []
    while_loop = jax.lax.while_loop

    def recording(cond, body, init):
        out = while_loop(cond, body, init)
        exits.append((int(out[4]), bool(out[5])))
        return out

    monkeypatch.setattr(jax.lax, "while_loop", recording)
    value = float(jfid._trace_sqrtm_newton_schulz(jnp.asarray(s1), jnp.asarray(s2)))
    monkeypatch.undo()
    (steps, froze), = exits
    return value, steps, froze


@pytest.mark.parametrize("n,dim", [(100, 256), (600, 512), (400, 64), (30, 48)])
def test_newton_schulz_stops_where_jax_stops(monkeypatch, n, dim):
    """Rank-deficient and full-rank covariances: the frozen iterate's trace
    within 1e-2 of the exact value (as the JAX package holds its own) and of
    the JAX package's, and the loop ran as many steps and froze (or not) as
    the JAX package's loop."""
    from scipy import linalg

    rng = np.random.RandomState(11)
    f1 = rng.randn(n, dim).astype(np.float32)
    f2 = (rng.randn(n, dim) * 1.5 + 0.4).astype(np.float32)
    s1, s2 = np.cov(f1, rowvar=False).astype(np.float32), np.cov(f2, rowvar=False).astype(np.float32)
    exact = float(np.trace(linalg.sqrtm(s1.astype(np.float64) @ s2.astype(np.float64)).real))
    j_val, j_steps, j_froze = _jax_newton_schulz(monkeypatch, s1, s2)
    t_val, t_steps, t_froze = tfid._newton_schulz(torch.from_numpy(s1), torch.from_numpy(s2))
    assert (int(t_steps), bool(t_froze)) == (j_steps, j_froze)
    assert np.isfinite(float(t_val))
    np.testing.assert_allclose(float(t_val), exact, rtol=NS_RTOL)
    np.testing.assert_allclose(float(t_val), j_val, rtol=NS_RTOL)
    assert float(tfid._trace_sqrtm_newton_schulz(torch.from_numpy(s1), torch.from_numpy(s2))) == float(t_val)


@pytest.mark.parametrize("n,dim", [(100, 256), (600, 512), (400, 64), (30, 48)])
def test_newton_schulz_float64_stops_where_jax_x64_stops(monkeypatch, n, dim):
    """The metric's compute passes float64 covariances: on those the port's
    loop runs as many steps and freezes (or not) as the JAX package's loop
    run with x64 on, and its trace is within 1e-2 of the exact value and
    within 1e-6 of the JAX package's."""
    from scipy import linalg

    rng = np.random.RandomState(11)
    f1 = rng.randn(n, dim)
    f2 = rng.randn(n, dim) * 1.5 + 0.4
    s1, s2 = np.cov(f1, rowvar=False), np.cov(f2, rowvar=False)
    exact = float(np.trace(linalg.sqrtm(s1 @ s2).real))
    with jax.enable_x64(True):
        j_val, j_steps, j_froze = _jax_newton_schulz(monkeypatch, s1, s2)
    t_val, t_steps, t_froze = tfid._newton_schulz(torch.from_numpy(s1), torch.from_numpy(s2))
    assert t_val.dtype == torch.float64
    assert (int(t_steps), bool(t_froze)) == (j_steps, j_froze)
    np.testing.assert_allclose(float(t_val), exact, rtol=NS_RTOL)
    np.testing.assert_allclose(float(t_val), j_val, rtol=1e-6)


def test_sqrtm_method_picks_and_refusals_match_jax():
    s = torch.eye(4)
    with tracing():
        # a CPU tensor takes eigh, traced or not, as the JAX package's CPU backend does
        np.testing.assert_allclose(float(tfid._trace_sqrtm_product(s, s)), 4.0, rtol=1e-6)
        with pytest.raises(ValueError) as port:
            tfid._trace_sqrtm_product(s, s, method="eigh_host")
    with pytest.raises(ValueError) as ref:
        jax.jit(lambda a: jfid._trace_sqrtm_product(a, a, method="eigh_host"))(jnp.eye(4))
    assert str(port.value) == str(ref.value)
    for bad in ("cholesky",):
        with pytest.raises(ValueError) as port:
            TFID(sqrtm_method=bad, device="cpu")
        with pytest.raises(ValueError) as ref:
            JFID(sqrtm_method=bad)
        assert str(port.value) == str(ref.value)
        with pytest.raises(ValueError) as port:
            tfid._trace_sqrtm_product(s, s, method=bad)
        with pytest.raises(ValueError) as ref:
            jfid._trace_sqrtm_product(jnp.eye(4), jnp.eye(4), method=bad)
        assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("kwargs", [
    {"feature_shift": 1.0}, {"feature_dim": 4, "feature_shift": np.zeros(3)}, {"feature_dim": 0},
    {"reset_real_features": 1},
], ids=["shift-without-dim", "shift-shape", "dim-zero", "reset-not-bool"])
def test_constructor_errors_match_jax(kwargs):
    with pytest.raises(ValueError) as port:
        TFID(**kwargs, device="cpu")
    with pytest.raises(ValueError) as ref:
        JFID(**kwargs)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("kwargs", [{}, {"feature_dim": 8}], ids=["list", "moments"])
def test_empty_side_and_bad_features_raise_as_jax(kwargs):
    jm, tm = JFID(**kwargs), TFID(**kwargs, device="cpu")
    x = _features(1, 10, 8)
    jm.update(_jnp(x), real=True)
    tm.update(_t(x), real=True)
    with pytest.raises(ValueError) as port:
        tm.compute()
    with pytest.raises(ValueError) as ref:
        jm.compute()
    assert str(port.value) == str(ref.value) == "No samples to concatenate"
    for bad in (x[:, :4], x[:, :, None]):
        if bad.ndim == 2 and "feature_dim" not in kwargs:
            continue
        with pytest.raises(ValueError) as port:
            tm.update(_t(bad), real=False)
        with pytest.raises(ValueError) as ref:
            jm.update(_jnp(bad), real=False)
        assert str(port.value).replace("torch.Size(", "").replace("])", "]") == str(ref.value)


@pytest.mark.parametrize("kwargs", [{}, {"feature_dim": 8}], ids=["list", "moments"])
def test_reset_real_features_keeps_the_real_side(kwargs):
    batches = _batches(3, 8, sizes=(30,))
    new_fake = _features(77, 30, 8, shift=1.0)
    vals = []
    for cls, to, extra in ((JFID, _jnp, {}), (TFID, _t, {"device": "cpu"})):
        m = _fill(cls(reset_real_features=False, **kwargs, **extra), batches, to)
        m.reset()
        m.update(to(new_fake), real=False)
        vals.append(float(m.compute()))
        m2 = _fill(cls(**kwargs, **extra), batches, to)
        m2.reset()
        with pytest.raises(ValueError, match="No samples"):
            m2.update(to(new_fake), real=False)
            m2.compute()
    np.testing.assert_allclose(vals[1], vals[0], atol=_fid_tol(batches[0][0], new_fake))


def test_moment_checkpoints_cross_both_ways():
    batches = _batches(5, 8)
    jm = _fill(JFID(feature_dim=8), batches[:2], _jnp)
    jm.persistent(True)
    tm = TFID(feature_dim=8, device="cpu")
    tm.persistent(True)
    load_jax_state_dict(tm, jm.state_dict())
    assert tm.real_num_samples.dtype == torch.int32 and int(tm.real_num_samples) == 40
    back = JFID(feature_dim=8)
    back.load_state_dict(to_jax_state_dict(tm))
    for m, to in ((jm, _jnp), (tm, _t), (back, _jnp)):
        _fill(m, batches[2:], to)
    tol = _fid_tol(*_sides(batches))
    np.testing.assert_allclose(float(tm.compute()), float(jm.compute()), atol=tol)
    np.testing.assert_allclose(float(back.compute()), float(jm.compute()), atol=tol)


def test_engine_update_and_traced_compute_are_the_eager_ones():
    """``jit_update=True``: the moment states equal the eager update's bits;
    a compute inside ``tracing()`` takes the in-graph moments form (the JAX
    package's jitted compute) and matches the eager value."""
    batches = _batches(9, 8)
    eager = _fill(TFID(feature_dim=8, device="cpu"), batches, _t)
    engine = _fill(TFID(feature_dim=8, jit_update=True, device="cpu"), batches, _t)
    for key in eager._defaults:
        assert torch.equal(getattr(engine, key), getattr(eager, key)), key
    assert engine.dispatch_stats["dispatches"] == len(batches)
    jm = _fill(JFID(feature_dim=8), batches, _jnp)
    traced = jax.jit(jm.pure_compute)(jm.state())
    with tracing():
        got = eager._compute_impl()
    tol = _fid_tol(*_sides(batches))
    np.testing.assert_allclose(float(got), float(traced), atol=tol)
    np.testing.assert_allclose(float(got), float(eager.compute()), atol=tol)


@pytest.fixture(scope="module")
def fid_weights(tmp_path_factory):
    """A synthetic InceptionV3 tree whose kernels are scaled to keep the
    activations' size (the JAX test's 0.05 kernels grow them until two float32
    runs drift apart), written by the JAX package."""
    state = _make_inception_state(seed=31)
    for key, value in state.items():
        if key.endswith("conv.weight") or key == "fc.weight":
            fan_in = value[0].numel()
            state[key] = value * (np.sqrt((2.0 if key.endswith("conv.weight") else 1.0) / fan_in) / 0.05)
    path = str(tmp_path_factory.mktemp("fid") / "inception.npz")
    jnet.save_params(path, unflatten_dict(convert_state_dict(state), sep="/"))
    return path


def test_bundled_net_fid_matches_jax(fid_weights):
    """``feature=64`` with the same weights: the same features (atol 1e-5)
    and FID, for uint8 images in both layouts. 80 images a side keep the
    64 x 64 covariances full rank (a rank-deficient one's square root sums
    the eigensolvers' rounding of its zero eigenvalues)."""
    rng = np.random.RandomState(41)
    real = (rng.rand(80, 75, 75, 3) * 255).astype(np.uint8)
    fake = (rng.rand(80, 3, 75, 75) * 200).astype(np.uint8)
    jm = JFID(feature=64, weights_path=fid_weights)
    tm = TFID(feature=64, weights_path=fid_weights, device="cpu")
    for m, to in ((jm, _jnp), (tm, _t)):
        m.update(to(real), real=True)
        m.update(to(fake), real=False)
    for key in ("real_features", "fake_features"):
        np.testing.assert_allclose(torch.cat(getattr(tm, key)).numpy(), np.concatenate(getattr(jm, key)), atol=1e-5)
    r, f = torch.cat(tm.real_features).numpy(), torch.cat(tm.fake_features).numpy()
    np.testing.assert_allclose(float(tm.compute()), float(jm.compute()), atol=_fid_tol(r, f))
    copy = tm.clone()
    assert copy.feature_extractor is not tm.feature_extractor and copy._device_attributes == ("feature_extractor",)
    assert torch.equal(copy.compute(), tm.compute())
