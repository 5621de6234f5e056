"""``metrics_tpu_torch.utilities.jax_random`` bit for bit against
``jax.random`` (threefry2x32, ``jax_threefry_partitionable`` on, x64 off) on
the CPU, and ``as_rng_key`` against the JAX package's: the draws KID's
``compute_rng_key`` and IS's ``assignment_rng_key`` take."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.utilities.checks import as_rng_key as jax_as_rng_key
from metrics_tpu_torch.utilities import jax_random
from metrics_tpu_torch.utilities.checks import as_rng_key

SEEDS = np.random.RandomState(2020).randint(-(2**31), 2**31 - 1, size=1000)
SHAPES = ((), (7,), (2, 2, 3))


def _words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


def test_draws_are_jax_random_bit_for_bit():
    """1,000 seeds: PRNGKey, split, fold_in, and uniform and randint at
    several shapes equal ``jax.random``'s raw words and float bits (randint
    over a span past 2**16, where the modulus rule's product wraps, on the
    first 100 seeds)."""
    seeds = jnp.asarray(SEEDS, jnp.int32)
    keys = jax.vmap(jax.random.PRNGKey)(seeds)
    splits = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    folded = jax.vmap(lambda k: jax.random.fold_in(k, 12345))(keys)
    uniforms = {s: jax.vmap(lambda k: jax.random.uniform(k, s))(keys) for s in SHAPES}
    ints = {s: jax.vmap(lambda k: jax.random.randint(k, s, 0, 10))(keys) for s in SHAPES}
    wide = jax.vmap(lambda k: jax.random.randint(k, (3, 5), -70000, 2**31 - 1))(keys)
    for i, seed in enumerate(SEEDS.tolist()):
        key = jax_random.PRNGKey(seed)
        assert np.array_equal(key.numpy(), _words(keys[i]))
        assert np.array_equal(jax_random.split(key, 3).numpy(), _words(splits[i]))
        assert np.array_equal(jax_random.fold_in(key, 12345).numpy(), _words(folded[i]))
        for shape in SHAPES:
            u = jax_random.uniform(key, shape)
            assert u.dtype == torch.float32 and u.shape == shape
            assert np.array_equal(u.numpy().view(np.int32), np.asarray(uniforms[shape][i]).view(np.int32))
            r = jax_random.randint(key, shape, 0, 10)
            assert r.dtype == torch.int32 and np.array_equal(r.numpy(), np.asarray(ints[shape][i]))
        if i < 100:
            assert np.array_equal(jax_random.randint(key, (3, 5), -70000, 2**31 - 1).numpy(), np.asarray(wide[i]))


def test_fold_in_takes_a_device_count_and_wraps_negative_int32():
    key = jax.random.PRNGKey(7)
    for data in (0, 1, 2**31 - 1, -1, -(2**31)):
        got = jax_random.fold_in(jax_random.PRNGKey(7), torch.tensor(data, dtype=torch.int32))
        assert np.array_equal(got.numpy(), _words(jax.random.fold_in(key, jnp.int32(data))))


def test_prngkey_wraps_like_x32_jax_and_refuses_past_int64():
    for seed in (0, 1, -1, 2**31, 2**33 + 5, -(2**40) - 3, 2**63 - 1):
        assert np.array_equal(jax_random.PRNGKey(seed).numpy(), _words(jax.random.PRNGKey(seed)))
    for package in (jax.random.PRNGKey, jax_random.PRNGKey):
        with pytest.raises(OverflowError):
            package(2**64)


def test_as_rng_key_accepts_seeds_and_raw_key_data():
    raw = np.asarray(jax.random.PRNGKey(11))
    assert np.array_equal(as_rng_key(11, "k").numpy(), _words(jax_as_rng_key(11, "k")))
    assert np.array_equal(as_rng_key(raw, "k").numpy(), _words(raw))
    assert np.array_equal(as_rng_key(torch.from_numpy(raw.astype(np.int64)).to(torch.uint32), "k").numpy(), _words(raw))
    for bad in (1.5, True, "3", np.zeros(2, np.int32), np.zeros(3, np.uint32), torch.zeros(2, dtype=torch.int64)):
        with pytest.raises(ValueError, match="expected to be an int seed or a jax.random key") as port:
            as_rng_key(bad, "compute_rng_key")
        with pytest.raises(ValueError) as ref:
            jax_as_rng_key(jnp.asarray(bad) if isinstance(bad, np.ndarray) else bad, "compute_rng_key")
        assert str(port.value).split(" got ")[0] == str(ref.value).split(" got ")[0]
