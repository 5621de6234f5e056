"""The session axis of the ``countmin`` kernel (metrics_tpu_torch/ops/sketch_ops.py) against the JAX package.

``countmin_update_sessions`` is what ``jax.vmap`` makes of ``countmin_update``
in the JAX service's flush (``metrics_tpu/serve.py:1493``). On the CPU the
port runs its plain version, one ``index_add_`` over the ``S * depth *
width`` cells, which must equal ``jax.vmap`` of the JAX package's lax update
and of its Pallas kernel (interpret mode) bit for bit for integral weights,
and agree to float32 rounding (rtol 1e-6) for fractional ones, whose sums
come in another order. ``CountMinHeavyHitters._stacked_masked_update`` must
equal each session's own masked update, NaN keys, padded rows and weights
included, and return ``None`` where another path applies; a service of
count-min sketches must stay digest-equal to the JAX service, one stacked
launch a flush. The kernel itself runs on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` slice 15).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu_torch
from metrics_tpu import serve as jserve
from metrics_tpu.ops.sketch_ops import _countmin_lax, _countmin_pallas
from metrics_tpu_torch.ops import countmin_update, countmin_update_sessions, launches, reset_launches
from metrics_tpu_torch.ops.sketch_ops import countmin_sessions_plan, countmin_plan
from metrics_tpu_torch.serve import MetricsService

H100_SMS, H100_OPTIN = 132, 232_448


def _seeds(depth):
    return (np.arange(depth, dtype=np.uint32) * np.uint32(0x9E3779B9) + np.uint32(1)).astype(np.uint32)


def _inputs(sessions, n, depth, width, seed, integral=True):
    rng = np.random.RandomState(seed)
    values = rng.randint(0, 7, (sessions, depth, width)).astype(np.float32)
    bits = (rng.zipf(1.3, (sessions, n)) % 500).astype(np.uint32)  # heavy repeats inside a warp
    bits[:, :2] = np.array([0, 2**32 - 1], np.uint32)[: min(n, 2)]
    w = (rng.randint(0, 4, (sessions, n)) if integral else rng.rand(sessions, n)).astype(np.float32)
    return values, bits, w, _seeds(depth)


def _t(x):
    return torch.from_numpy(np.array(x))


def _vmapped(fn, values, bits, w, seeds):
    return np.asarray(jax.vmap(fn, in_axes=(0, 0, 0, None))(*(jnp.asarray(a) for a in (values, bits, w)),
                                                              jnp.asarray(seeds)))


@pytest.mark.parametrize("sessions,n,depth,width", [
    (1, 1, 1, 1), (3, 37, 4, 64), (8, 200, 4, 1000), (16, 513, 2, 1023), (5, 64, 8, 128),
])
def test_plain_session_axis_equals_the_vmapped_jax_update_bit_for_bit(sessions, n, depth, width):
    values, bits, w, seeds = _inputs(sessions, n, depth, width, seed=sessions * n)
    got = countmin_update_sessions(_t(values), _t(bits), _t(w), _t(seeds)).numpy()
    np.testing.assert_array_equal(got, _vmapped(_countmin_lax, values, bits, w, seeds))
    pallas = functools.partial(_countmin_pallas, interpret=True)
    np.testing.assert_array_equal(got, _vmapped(pallas, values, bits, w, seeds))
    # and each session's table is the single-table update's
    for s in range(sessions):
        single = countmin_update(_t(values[s]), _t(bits[s]), _t(w[s]), _t(seeds)).numpy()
        np.testing.assert_array_equal(got[s], single)


def test_fractional_weights_agree_to_float32_rounding():
    values, bits, w, seeds = _inputs(6, 3000, 3, 64, seed=9, integral=False)
    got = countmin_update_sessions(_t(values), _t(bits), _t(w), _t(seeds)).numpy()
    np.testing.assert_allclose(got, _vmapped(_countmin_lax, values, bits, w, seeds), rtol=1e-6, atol=0)


def test_int32_views_zero_keys_and_no_cpu_launch():
    values, bits, w, seeds = _inputs(4, 50, 4, 64, seed=3)
    reset_launches()
    a = countmin_update_sessions(_t(values), _t(bits.view(np.int32)), _t(w), _t(seeds.view(np.int32)))
    b = countmin_update_sessions(_t(values), _t(bits).view(torch.uint32), _t(w), _t(seeds))
    assert torch.equal(a, b) and launches()["countmin"] == 0
    empty = countmin_update_sessions(_t(values), torch.zeros((4, 0), dtype=torch.int32), torch.zeros((4, 0)),
                                     _t(seeds))
    assert torch.equal(empty, _t(values))


def test_session_axis_rejects_bad_shapes_and_devices():
    v, b, w, s = torch.zeros(2, 4, 8), torch.zeros(2, 5, dtype=torch.int32), torch.ones(2, 5), torch.zeros(4,
                                                                                                       dtype=torch.int32)
    with pytest.raises(ValueError):
        countmin_update_sessions(v[0], b, w, s)
    with pytest.raises(ValueError):
        countmin_update_sessions(v, b, w[:, :3], s)
    with pytest.raises(ValueError):
        countmin_update_sessions(v, b[:1], w[:1], s)
    with pytest.raises(ValueError):
        countmin_update_sessions(v, b, w, s[:3])
    with pytest.raises(RuntimeError):
        countmin_update_sessions(v.to("meta"), b.to("meta"), w.to("meta"), s.to("meta"))


def test_plans_choose_by_the_table_and_the_shared_limit():
    # slice 14 B's flush: 256 tables of 4 x 1024, 4,096 keys each: a block a session, 7 warps (two blocks an SM,
    # one wave; 8 warps fit one block an SM, two waves)
    assert countmin_sessions_plan(256, 4096, 4, 1024, H100_SMS, H100_OPTIN) == ("sessions", 256, 7)
    # few sessions: every block has its own SM, so the most warps
    assert countmin_sessions_plan(8, 4096, 4, 1024, H100_SMS, H100_OPTIN) == ("sessions", 8, 8)
    # few keys: no more warps than the keys fill
    assert countmin_sessions_plan(4, 40, 4, 1024, H100_SMS, H100_OPTIN) == ("sessions", 4, 2)
    # a table past the shared limit: global atomics over every session's keys
    assert countmin_sessions_plan(4, 65536, 4, 65536, H100_SMS, H100_OPTIN) == ("sessions-global", 1024, 0)
    assert countmin_sessions_plan(2, 10, 4, 65536, H100_SMS, H100_OPTIN) == ("sessions-global", 1, 0)
    # the same shared-memory rule as the single table's
    for depth, width in ((4, 1024), (8, 4096), (4, 65536)):
        shared = countmin_plan(1, depth, width, H100_SMS, H100_OPTIN)[0] == "shared"
        assert (countmin_sessions_plan(8, 4096, depth, width, H100_SMS, H100_OPTIN)[0] == "sessions") is shared


# ------------------------------------------------------------- the stacked hook
def _sketch(**kwargs):
    return metrics_tpu_torch.CountMinHeavyHitters(depth=4, width=64, device="cpu", **kwargs)


@pytest.mark.parametrize("weight", ["one", "number", "tensor"])
@pytest.mark.parametrize("nan_strategy", ["warn", "ignore", 3.5])
def test_stacked_hook_equals_each_sessions_masked_update(weight, nan_strategy):
    rng = np.random.RandomState(11)
    sessions, b = 5, 24
    keys = rng.randint(0, 40, (sessions, b)).astype(np.float32)
    keys[1, 3] = np.nan
    keys[2, 0] = -0.0
    n_valid = np.array([24, 7, 0, 13, 24])
    mask = torch.arange(b)[None, :] < torch.from_numpy(n_valid)[:, None]
    tmpl = _sketch(nan_strategy=nan_strategy)
    rows = {"value": torch.from_numpy(rng.randint(0, 3, (sessions, 4, 64)).astype(np.float32))}
    kwargs = {"number": {"weight": 2.5}, "tensor": {"weight": torch.from_numpy(rng.rand(sessions, b).astype(
        np.float32))}, "one": {}}[weight]
    from metrics_tpu_torch.utilities.checks import tracing

    with tracing():
        got = tmpl._stacked_masked_update(rows, mask, torch.from_numpy(keys), **kwargs)
    for s in range(sessions):
        lane_kwargs = {k: (v[s] if isinstance(v, torch.Tensor) else v) for k, v in kwargs.items()}
        with tracing():
            want = tmpl._masked_pure_update({"value": rows["value"][s]}, mask[s], torch.from_numpy(keys[s]),
                                            **lane_kwargs)
        assert torch.equal(got["value"][s], want["value"]), s


def test_stacked_hook_declines_other_paths():
    tmpl = _sketch()
    rows = {"value": torch.zeros(2, 4, 64)}
    mask = torch.ones(2, 8, dtype=torch.bool)
    assert tmpl._stacked_masked_update(rows, mask, torch.zeros(2, 8, 3)) is None  # a lane's keys are not 1-D
    assert tmpl._stacked_masked_update(rows, mask, torch.zeros(2, 8), weight=torch.ones(2, 4)) is None

    class Subclass(metrics_tpu_torch.CountMinHeavyHitters):
        def _masked_update(self, sample_mask, value, weight=1.0):
            super()._masked_update(sample_mask, value, weight)

    assert Subclass(depth=4, width=64, device="cpu")._stacked_masked_update(rows, mask, torch.zeros(2, 8)) is None


def test_a_count_min_service_is_one_launch_a_flush_and_the_jax_services_digest():
    rng = np.random.RandomState(12)
    port = MetricsService(_sketch())
    ref = jserve.MetricsService(metrics_tpu.CountMinHeavyHitters(depth=4, width=64))
    dedicated = {}
    for f in range(3):
        for i in range(9):
            ids = (rng.zipf(1.2, 20 + 7 * i) % 300).astype(np.float32)
            if i == 4:
                ids[3] = np.nan
            name = f"adv{i}"
            port.submit(name, torch.from_numpy(ids))
            ref.submit(name, jnp.asarray(ids))
            dedicated.setdefault(name, _sketch()).update(torch.from_numpy(ids))
        port.drain()
        ref.drain()
        # the ragged sizes, 20 to 76 keys, fill three batch buckets (32, 64, 128): one launch each
        assert port.stats["launches"] == ref.stats["launches"] == 3 * (f + 1)
    assert port.stats["fallback_requests"] == ref.stats["fallback_requests"] == 0
    assert port.state_digest() == ref.state_digest()
    for name, sk in dedicated.items():
        assert torch.equal(port._stacked["value"][port._rows[name]], sk.value)
    values, jvalues = port.compute_all(), ref.compute_all()
    for name in values:
        np.testing.assert_array_equal(values[name].numpy(), np.asarray(jvalues[name]))
