"""LPIPS in the port against the JAX package, on the CPU: the three networks
(AlexNet and SqueezeNet at 64 x 64, VGG16 at 32 x 32), the metric, the
gradient with respect to the first image, the ``.npz`` weights both ways,
checkpoints and the engine's update.

The JAX trees come from the JAX tests' synthetic ``lpips`` checkpoints
(``tests/image/test_full_net_cross_check.py``) through
``tools/convert_lpips_weights.convert`` and the JAX package's
``save_params``; both packages load the same file. Tolerances: distances
within 1e-5 (float32), the gradient within 1e-4 of ``jax.grad``'s.
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

import metrics_tpu.image.inception_net as jnet  # noqa: E402
import metrics_tpu.image.lpips_net as jlpips  # noqa: E402
from convert_lpips_weights import convert as convert_lpips  # noqa: E402
from metrics_tpu.image import LearnedPerceptualImagePatchSimilarity as JLPIPS  # noqa: E402
from metrics_tpu_torch.image import LearnedPerceptualImagePatchSimilarity as TLPIPS  # noqa: E402
from metrics_tpu_torch.image import lpips_net as tlpips  # noqa: E402
from metrics_tpu_torch.image.inception_net import save_params  # noqa: E402
from metrics_tpu_torch.interop import load_jax_state_dict, to_jax_state_dict  # noqa: E402
from tests.image.test_full_net_cross_check import _make_lpips_state  # noqa: E402

ATOL, GRAD_ATOL = 1e-5, 1e-4
HW = {"alex": 64, "squeeze": 64, "vgg": 32}
NETS = ("alex", "squeeze", "vgg")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A JAX ``.npz`` a network, written by the JAX package."""
    root = tmp_path_factory.mktemp("lpips")
    out = {}
    for net in NETS:
        backbone, lins = _make_lpips_state(net, seed=44)
        out[net] = str(root / f"{net}.npz")
        jnet.save_params(out[net], unflatten_dict(convert_lpips(backbone, lins, net), sep="/"))
    return out


_JAX_NETS = {}


def _jax_net(net, path):
    """The JAX package's network of ``path``, one a file (each holds its compiled forward)."""
    if path not in _JAX_NETS:
        _JAX_NETS[path] = jlpips.LPIPSNet(net_type=net, weights_path=path)
    return _JAX_NETS[path]


def _pairs(net, seed, n=3, layout="nchw"):
    rng = np.random.RandomState(seed)
    a = (rng.rand(n, 3, HW[net], HW[net]) * 2 - 1).astype(np.float32)
    b = np.clip(a + 0.3 * rng.randn(*a.shape), -1, 1).astype(np.float32)
    if layout == "nhwc":
        a, b = a.transpose(0, 2, 3, 1).copy(), b.transpose(0, 2, 3, 1).copy()
    return a, b


@pytest.mark.parametrize("net,layout", [("alex", "nchw"), ("alex", "nhwc"), ("squeeze", "nchw"), ("vgg", "nchw")])
def test_net_matches_jax(weights, net, layout):
    a, b = _pairs(net, 1, layout=layout)
    want = np.asarray(_jax_net(net, weights[net])(jnp.asarray(a), jnp.asarray(b)))
    got = tlpips.LPIPSNet(net_type=net, weights_path=weights[net])(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (a.shape[0],)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    same = tlpips.LPIPSNet(net_type=net, weights_path=weights[net])(torch.from_numpy(a), torch.from_numpy(a))
    assert torch.equal(same, torch.zeros_like(same))


@pytest.mark.parametrize("net", NETS)
def test_npz_crosses_both_ways_byte_for_byte(weights, net, tmp_path):
    port = tlpips.LPIPSNet(net_type=net, weights_path=weights[net])
    again = str(tmp_path / "again.npz")
    save_params(again, port.net.flat_params())
    assert open(again, "rb").read() == open(weights[net], "rb").read()
    born = tlpips.LPIPSNet(net_type=net)
    born_path = str(tmp_path / "born.npz")
    save_params(born_path, born.net.flat_params())
    variables = jnet.load_params(born_path)
    rewritten = str(tmp_path / "rewritten.npz")
    jnet.save_params(rewritten, variables)
    assert open(rewritten, "rb").read() == open(born_path, "rb").read()
    if net != "vgg":  # the seeded network's distances through the JAX package's forward
        a, b = _pairs(net, 2)
        jax_net = _jax_net(net, weights[net])
        want = np.asarray(jax_net._jitted(variables, jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(born(torch.from_numpy(a), torch.from_numpy(b)).numpy(), want, atol=ATOL)


def test_gradient_matches_jax_grad(weights):
    """d(sum of distances) / d img1, through the port's autograd and the
    metric's value, against ``jax.grad`` of the JAX network."""
    net = "alex"
    a, b = _pairs(net, 3, n=2)
    jnet_ = jlpips.LPIPSNet(net_type=net, weights_path=weights[net])
    want = np.asarray(jax.grad(lambda x: jnet_(x, jnp.asarray(b)).sum())(jnp.asarray(a)))
    x = torch.from_numpy(a).requires_grad_(True)
    metric = TLPIPS(net_type=net, weights_path=weights[net], reduction="sum", device="cpu")
    value = metric(x, torch.from_numpy(b))
    value.backward()
    np.testing.assert_allclose(x.grad.numpy(), want, atol=GRAD_ATOL)
    assert TLPIPS.is_differentiable and not any(p.requires_grad for p in metric.net.parameters())


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_metric_matches_jax(weights, reduction):
    jm = JLPIPS(net_type="alex", weights_path=weights["alex"], reduction=reduction)
    tm = TLPIPS(net_type="alex", weights_path=weights["alex"], reduction=reduction, device="cpu")
    for seed in (4, 5):
        a, b = _pairs("alex", seed)
        jm.update(jnp.asarray(a), jnp.asarray(b))
        tm.update(torch.from_numpy(a), torch.from_numpy(b))
    assert tm.sum_scores.dtype == tm.total.dtype == torch.float32 and float(tm.total) == 6.0
    np.testing.assert_allclose(float(tm.compute()), float(jm.compute()), atol=ATOL)


def test_metric_checkpoints_engine_and_copies(weights):
    """A state crosses both ways; ``jit_update=True`` is the eager update's
    bits; a clone holds its own network on the metric's device."""
    jm = JLPIPS(net_type="alex", weights_path=weights["alex"])
    a, b = _pairs("alex", 6)
    jm.update(jnp.asarray(a), jnp.asarray(b))
    jm.persistent(True)
    tm = TLPIPS(net_type="alex", weights_path=weights["alex"], device="cpu")
    tm.persistent(True)
    load_jax_state_dict(tm, jm.state_dict())
    back = JLPIPS(net_type="alex", weights_path=weights["alex"])
    back.load_state_dict(to_jax_state_dict(tm))
    c, d = _pairs("alex", 7)
    for m, to in ((jm, jnp.asarray), (tm, torch.from_numpy), (back, jnp.asarray)):
        m.update(to(c), to(d))
    np.testing.assert_allclose(float(tm.compute()), float(jm.compute()), atol=ATOL)
    np.testing.assert_allclose(float(back.compute()), float(jm.compute()), atol=ATOL)

    eager = TLPIPS(net_type="alex", weights_path=weights["alex"], device="cpu")
    engine = TLPIPS(net_type="alex", weights_path=weights["alex"], jit_update=True, device="cpu")
    for x, y in (_pairs("alex", 8), _pairs("alex", 9)):
        eager.update(torch.from_numpy(x), torch.from_numpy(y))
        engine.update(torch.from_numpy(x), torch.from_numpy(y))
    assert torch.equal(eager.sum_scores, engine.sum_scores) and torch.equal(eager.total, engine.total)
    copy = eager.clone()
    assert copy.net is not eager.net and copy._device_attributes == ("net",)
    assert torch.equal(copy.compute(), eager.compute())


def test_default_nets_warn_and_are_seeded():
    message = "LPIPSNet built without `weights_path`: the backbone is randomly initialized"
    for net in NETS:
        with pytest.warns(UserWarning, match=message):
            a = tlpips.LPIPSNet(net_type=net)
        b = tlpips.LPIPSNet(net_type=net)
        assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    with pytest.warns(UserWarning, match=message):
        metric = TLPIPS(device="cpu")
    assert isinstance(metric.net, tlpips.LPIPSNet) and metric.net.net.net_type == "alex"


@pytest.mark.parametrize("net", NETS)
def test_default_nets_give_distances(net):
    """The seeded heads are non-negative, as lpips keeps them: identical
    pairs score 0, noisy pairs above 0 and more noise scores higher."""
    with pytest.warns(UserWarning):
        model = tlpips.LPIPSNet(net_type=net)
    heads = [getattr(model.net, f"lin{i}").model[1].weight for i in range(len(tlpips._TAP_WIDTHS[net]))]
    assert all(bool((w >= 0).all()) for w in heads)
    a, b = _pairs(net, 10, n=4)
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    same, near, far = model(a, a), model(a, (a + 0.5 * (b - a))), model(a, b)
    assert torch.equal(same, torch.zeros_like(same))
    assert bool((near > 0).all()) and bool((far > near).all())


def test_errors_match_jax():
    for kwargs in ({"net_type": "resnet"}, {"net": lambda a, b: a, "reduction": "max"}):
        with pytest.raises(ValueError) as port:
            TLPIPS(**kwargs, device="cpu")
        with pytest.raises(ValueError) as ref:
            JLPIPS(**kwargs)
        assert str(port.value) == str(ref.value)
