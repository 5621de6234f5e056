"""The InceptionV3 of the image metrics in the port against the JAX package,
on the CPU: the trunk and its feature extractor, the ``.npz`` weights both
ways, and the bundled-extractor constructor rules.

The JAX trees are built without flax's eager init: a synthetic
``torch_fidelity`` state dict (``tests/image/test_weight_conversion.py``)
through ``tools/convert_inception_weights.convert_state_dict``, written with
the JAX package's ``save_params`` and loaded by both packages. The nets are
compared in float64 (the JAX side under x64), as the JAX package's own torch
cross-check compares them: its synthetic weights grow the activations so
that two float32 runs drift apart by summation order alone. Tolerances: pool
features atol 1e-5 and logits atol 1e-4 (``tests/image/test_full_net_cross_check.py``),
the taps 1e-6 of each tap's largest magnitude.
"""
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import metrics_tpu.image.inception_net as jnet  # noqa: E402
from convert_inception_weights import convert_state_dict  # noqa: E402
from metrics_tpu._compat import enable_x64  # noqa: E402
from metrics_tpu_torch.image import inception_net as tnet  # noqa: E402
from tests.image.test_weight_conversion import _make_inception_state  # noqa: E402

POOL_ATOL, LOGITS_ATOL, TAP_RTOL = 1e-5, 1e-4, 1e-6
HW = 75  # the network's smallest input


# ------------------------------------------------------------------ InceptionV3
@pytest.fixture(scope="module")
def inception(tmp_path_factory):
    """The JAX tree on disk, the images (uint8, 75 x 75) and the JAX trunk's
    float64 outputs: features, logits and the three taps, from one jitted apply."""
    path = str(tmp_path_factory.mktemp("inception") / "inception.npz")
    jnet.save_params(path, unflatten_dict(convert_state_dict(_make_inception_state(seed=21)), sep="/"))
    images = (np.random.RandomState(22).rand(3, HW, HW, 3) * 255).astype(np.uint8)
    x = (images.astype(np.float32) / 127.5 - 1.0).astype(np.float64)
    with enable_x64(True):
        variables = jnet.load_params(path)
        apply = jax.jit(lambda v, x: jnet.InceptionV3(dtype=jnp.float64).apply(v, x, mutable=["intermediates"]))
        (features, logits), inter = apply(variables, jnp.asarray(x))
        taps = {k: np.asarray(inter["intermediates"][f"tap_{k}"][0]) for k in (64, 192, 768)}
        out = {"features": np.asarray(features), "logits": np.asarray(logits), "taps": taps,
               "bias": np.asarray(variables["params"]["Dense_0"]["bias"], np.float64)}
    return path, images, out


def _extractor(path, output, dtype=torch.float64):
    return tnet.InceptionV3FeatureExtractor(weights_path=path, output=output, dtype=dtype)


@pytest.fixture(scope="module")
def extractor64(inception):
    """One float64 extractor of the JAX tree; a test sets its ``output``."""
    return _extractor(inception[0], "pool")


def test_inception_trunk_matches_jax_in_float64(inception):
    path, images, ref = inception
    net = tnet.InceptionV3().load_flat(tnet.load_params(path)).double()
    x = torch.from_numpy(images).permute(0, 3, 1, 2).to(torch.float32) / 127.5 - 1.0
    features, logits = net(x.double())
    assert features.dtype == logits.dtype == torch.float64
    np.testing.assert_allclose(features.numpy(), ref["features"], atol=POOL_ATOL)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=LOGITS_ATOL)
    for tap, want in ref["taps"].items():
        got = net(x.double(), tap=tap).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, atol=TAP_RTOL * np.abs(want).max())


@pytest.mark.parametrize("output", ["pool", 2048, "logits", "logits_unbiased", 64, 192, 768], ids=str)
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_extractor_outputs_match_jax(inception, extractor64, output, layout):
    """uint8 in either layout: ``x / 127.5 - 1``, the outputs pooled to
    ``(N, C)``, ``logits_unbiased`` the logits less the head's bias."""
    path, images, ref = inception
    x = torch.from_numpy(images if layout == "nhwc" else np.ascontiguousarray(images.transpose(0, 3, 1, 2)))
    extractor64.output = "pool" if output == 2048 else output
    got = extractor64(x).numpy()
    if output in ("pool", 2048):
        np.testing.assert_allclose(got, ref["features"], atol=POOL_ATOL)
    elif output == "logits":
        np.testing.assert_allclose(got, ref["logits"], atol=LOGITS_ATOL)
    elif output == "logits_unbiased":
        np.testing.assert_allclose(got, ref["logits"] - ref["bias"], atol=LOGITS_ATOL)
    else:
        want = ref["taps"][output].mean(axis=(1, 2))
        assert got.shape == (images.shape[0], output)
        np.testing.assert_allclose(got, want, atol=TAP_RTOL * np.abs(ref["taps"][output]).max())


def test_extractor_float32_and_bfloat16_outputs(inception):
    """float32 and the bf16 option come back in float32; bf16 within 5% of
    the float32 features' scale."""
    path, images, ref = inception
    f32 = _extractor(path, "pool", torch.float32)(torch.from_numpy(images))
    bf16 = _extractor(path, "pool", torch.bfloat16)(torch.from_numpy(images))
    assert f32.dtype == bf16.dtype == torch.float32
    scale = np.abs(ref["features"]).max()
    assert np.abs(f32.numpy() - ref["features"]).max() < 1e-3 * scale
    assert np.abs(bf16.numpy() - ref["features"]).max() < 5e-2 * scale


def test_npz_crosses_both_ways_byte_for_byte(inception, tmp_path):
    """JAX file -> port -> file: the same bytes; port-born weights -> file ->
    the JAX trunk: the port's outputs."""
    path, images, _ = inception
    net = tnet.InceptionV3().load_flat(tnet.load_params(path))
    again = str(tmp_path / "again.npz")
    tnet.save_params(again, net.flat_params())
    assert open(again, "rb").read() == open(path, "rb").read()

    born = tnet.InceptionV3()
    born_path = str(tmp_path / "born.npz")
    tnet.save_params(born_path, born.flat_params())
    x = (images.astype(np.float32) / 127.5 - 1.0).astype(np.float64)
    with enable_x64(True):
        variables = jnet.load_params(born_path)
        assert set(variables) == {"params", "batch_stats"}
        features, logits = jax.jit(lambda v, x: jnet.InceptionV3(dtype=jnp.float64).apply(v, x))(variables, jnp.asarray(x))
    got_f, got_l = born.double()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(features), atol=POOL_ATOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(logits), atol=LOGITS_ATOL)
    rewritten = str(tmp_path / "rewritten.npz")
    jnet.save_params(rewritten, variables)
    assert open(rewritten, "rb").read() == open(born_path, "rb").read()


def test_state_dict_names_are_torch_fidelitys(inception):
    """The converter's torch names load as they are (``load_state_dict``),
    and give the weights the flat tree gives."""
    path, _, _ = inception
    state = _make_inception_state(seed=21)
    kept = {k: v for k, v in state.items() if not k.startswith("AuxLogits.")}
    net = tnet.InceptionV3()
    net.load_state_dict(kept)
    flat = tnet.load_params(path)
    for key, value in net.flat_params().items():
        assert np.array_equal(value, flat[key]), key


def test_seeded_init_is_deterministic_and_warns(tmp_path):
    message = "InceptionV3FeatureExtractor built without `weights_path`: the network is randomly initialized"
    with pytest.warns(UserWarning, match=message):
        a = tnet.InceptionV3FeatureExtractor()
    b = tnet.InceptionV3()
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.net.state_dict().items())
    assert not any(p.requires_grad for p in a.parameters())


def test_load_flat_refuses_a_tree_that_does_not_fit(inception):
    path, _, _ = inception
    flat = tnet.load_params(path)
    with pytest.raises(ValueError, match="missing"):
        tnet.InceptionV3().load_flat({k: v for k, v in flat.items() if "Mixed_7c" not in k and "InceptionE_1" not in k})
    flat["params/Dense_0/bias"] = np.zeros(1000, np.float32)
    with pytest.raises(ValueError, match="does not fit"):
        tnet.InceptionV3().load_flat(flat)


@pytest.mark.parametrize("output", ["poool", 100, "features"])
def test_extractor_output_errors_match_jax(output):
    with pytest.raises(ValueError) as port:
        tnet.InceptionV3FeatureExtractor(output=output)
    with pytest.raises(ValueError) as ref:
        jnet.InceptionV3FeatureExtractor(output=output)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("case", [
    dict(feature="logits_unbiased", allowed=(64, 192, 768, 2048)),
    dict(feature=100, allowed=("logits_unbiased", 64, 192, 768, 2048)),
    dict(feature=2048, explicit=True),
    dict(weights_path="w.npz", explicit=True),
], ids=["fid-string", "bad-tap", "feature-and-extractor", "weights-and-extractor"])
def test_ctor_sugar_errors_match_jax(case):
    args = dict(explicit=None, feature=None, weights_path=None, default_output=2048, allowed=None)
    args.update(case)
    if args["explicit"]:
        args["explicit"] = lambda x: x
    with pytest.raises(ValueError) as port:
        tnet.resolve_ctor_extractor(**args)
    with pytest.raises(ValueError) as ref:
        jnet.resolve_ctor_extractor(**args)
    assert str(port.value) == str(ref.value)


def test_ctor_sugar_builds_the_extractor_at_the_tap(inception):
    path, _, _ = inception
    assert tnet.resolve_ctor_extractor(None, None, None, 2048) is None
    for feature, want in ((None, "pool"), (np.int64(768), 768), (64.0, 64)):
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # a weights path: no warning
            ext = tnet.resolve_ctor_extractor(None, feature, path, default_output=2048)
        assert isinstance(ext, tnet.InceptionV3FeatureExtractor) and ext.output == want
    with pytest.raises(FileNotFoundError):
        tnet.resolve_ctor_extractor(None, 2048, path + ".missing", default_output=2048)
