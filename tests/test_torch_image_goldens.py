"""The port against the JAX package's three end-to-end goldens, through the
user path: a seeded PyTorch checkpoint on disk, the port's extractor or
net loading it (``weights_path=`` a ``.pth``), then the metric.

The goldens (``tests/image/*_end_to_end_golden.json``) hold the reference
pipeline's numbers (torch forward, float64 moments, scipy's ``sqrtm``) and
the JAX package's. The seeded generators are copies of the JAX tests' own
(``tests/image/test_weight_conversion.py::_make_inception_state``,
``tests/image/test_full_net_cross_check.py::_make_lpips_state`` and the
image makers of ``tests/image/test_fid_end_to_end.py``), so that the same
state dicts and images come out: RandomState draws in the flax tree's
sorted key order. Tolerances, relative: FID (reference, JAX list and
moments paths) 1e-5; IS 1e-10; KID 1e-5; LPIPS mean and sum in float64
1e-9 and the float32 user path's mean 1e-5.

Also here: the port's converters write the JAX tools' ``.npz`` bytes, and a
``.pth`` and its converted ``.npz`` give the same features.
"""
import json
import os
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from metrics_tpu_torch import (
    FrechetInceptionDistance,
    InceptionScore,
    KernelInceptionDistance,
    LearnedPerceptualImagePatchSimilarity,
)
from metrics_tpu_torch.image import inception_net, lpips_net
from metrics_tpu_torch.image.inception_net import InceptionV3FeatureExtractor
from metrics_tpu_torch.image.lpips_net import LPIPSNet

REPO = Path(__file__).resolve().parent.parent
GOLDENS = REPO / "tests" / "image"
TOOLS = REPO / "tools"


def _golden(name):
    return json.loads((GOLDENS / name).read_text())


# ------------------------------------------------------------------ the seeded generators (copies)
def _make_inception_state(seed=0, num_classes=1008):
    """torch_fidelity's state dict layout with seeded values: a copy of the
    JAX tests' generator (draws in the flax tree's sorted key order)."""
    net = inception_net.InceptionV3(num_classes=num_classes)
    names = net._flax_names()  # flax key -> torch name
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    rng = np.random.RandomState(seed)
    state = {}
    for key in sorted(names):
        name = names[key]
        shape = shapes[name]
        tail = ".".join(name.split(".")[-2:])
        if name in ("fc.weight", "fc.bias"):
            value = rng.randn(*shape)
        elif tail == "conv.weight":
            value = 0.05 * rng.randn(*shape)
        elif tail == "bn.weight":
            value = 1.0 + 0.1 * rng.randn(*shape)
        elif tail == "bn.running_var":
            value = 1.0 + 0.1 * np.abs(rng.randn(*shape))
        else:  # bn.bias / bn.running_mean
            value = 0.1 * rng.randn(*shape)
        state[name] = torch.from_numpy(value.astype(np.float32))
    # entries a converter must skip
    state["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    state["Conv2d_1a_3x3.bn.num_batches_tracked"] = torch.tensor(0)
    return state


_LPIPS_SHAPES = {
    "alex": [(64, 3, 11), (192, 64, 5), (384, 192, 3), (256, 384, 3), (256, 256, 3)],
    "vgg": [(64, 3, 3), (64, 64, 3), (128, 64, 3), (128, 128, 3), (256, 128, 3), (256, 256, 3), (256, 256, 3),
            (512, 256, 3), (512, 512, 3), (512, 512, 3), (512, 512, 3), (512, 512, 3), (512, 512, 3)],
}
_LPIPS_CONVS = {"alex": [0, 3, 6, 8, 10], "vgg": [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]}
_TAP_WIDTHS = {"alex": [64, 192, 384, 256, 256], "vgg": [64, 128, 256, 512, 512]}


def _make_lpips_state(net, seed):
    """(torchvision ``features`` state dict, lpips heads' checkpoint): a copy
    of the JAX tests' generator."""
    rng = np.random.RandomState(seed)
    backbone = {}
    for conv_idx, (o, i, k) in zip(_LPIPS_CONVS[net], _LPIPS_SHAPES[net]):
        backbone[f"{conv_idx}.weight"] = torch.from_numpy((0.3 / np.sqrt(i * k * k) * rng.randn(o, i, k, k))
                                                          .astype(np.float32))
        backbone[f"{conv_idx}.bias"] = torch.from_numpy(0.1 * rng.randn(o).astype(np.float32))
    lins = {f"lin{li}.model.1.weight": torch.from_numpy(np.abs(rng.randn(1, c, 1, 1)).astype(np.float32))
            for li, c in enumerate(_TAP_WIDTHS[net])}
    return backbone, lins


def _images(n, seed, hw=75):
    """Overlapping uint8 intensity distributions: real in [0, 200), fake in [100, 255)."""
    rng = np.random.RandomState(seed)
    real = rng.randint(0, 200, (n, 3, hw, hw)).astype(np.uint8)
    fake = rng.randint(100, 255, (n, 3, hw, hw)).astype(np.uint8)
    return real, fake


def _lpips_batches(net, seed, n_batches, batch, hw):
    rng = np.random.RandomState(seed)
    return [((rng.rand(batch, 3, hw, hw) * 2 - 1).astype(np.float32),
             (rng.rand(batch, 3, hw, hw) * 2 - 1).astype(np.float32)) for _ in range(n_batches)]


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Single-threaded convolutions: in a parallel test run every worker's
    default thread pool would oversubscribe the cores (this file took over
    ten times its single-threaded time there)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inception_pth(tmp_path_factory):
    state = _make_inception_state(seed=_golden("fid_end_to_end_golden.json")["state_seed"])
    path = tmp_path_factory.mktemp("inception") / "pt_inception.pth"
    torch.save(state, path)
    return state, str(path)


# ------------------------------------------------------------------ the goldens
def test_fid_matches_the_end_to_end_golden(inception_pth):
    golden = _golden("fid_end_to_end_golden.json")
    _, pth = inception_pth
    real, fake = _images(golden["n_per_side"], golden["img_seed"], golden["img_hw"])
    ext = InceptionV3FeatureExtractor(weights_path=pth, dtype=torch.float64)
    fid_list = FrechetInceptionDistance(feature_extractor=ext, sqrtm_method="eigh", device="cpu")
    fid_list.update(torch.from_numpy(real), real=True)
    fid_list.update(torch.from_numpy(fake), real=False)
    # the moments path on the same features (float64 moment sums, as the JAX package's moments path under x64:
    # a float32 outer sum loses this FID)
    fid_moments = FrechetInceptionDistance(sqrtm_method="eigh", feature_dim=2048, device="cpu").set_dtype(torch.float64)
    fid_moments.update(torch.cat(fid_list.real_features), real=True)
    fid_moments.update(torch.cat(fid_list.fake_features), real=False)
    got_list, got_moments = float(fid_list.compute()), float(fid_moments.compute())
    for got in (got_list, got_moments):
        assert _rel(got, golden["torch_fid"]) <= 1e-5
        assert _rel(got, golden["repo_fid_list"]) <= 1e-5
        assert _rel(got, golden["repo_fid_moments"]) <= 1e-5


def test_is_and_kid_match_the_end_to_end_golden(inception_pth):
    golden = _golden("is_kid_end_to_end_golden.json")
    fid_golden = _golden("fid_end_to_end_golden.json")
    n = golden["n_per_side"]
    _, pth = inception_pth
    real, fake = _images(n, fid_golden["img_seed"], fid_golden["img_hw"])
    logits = InceptionV3FeatureExtractor(weights_path=pth, output="logits_unbiased", dtype=torch.float64)
    is_list = InceptionScore(logits_extractor=logits, splits=1, device="cpu")
    is_list.update(torch.from_numpy(fake[: n // 2]))
    is_list.update(torch.from_numpy(fake[n // 2:]))
    # the streaming path on the same logits
    is_stream = InceptionScore(splits=1, num_classes=1008, device="cpu")
    for batch in is_list.features:
        is_stream.update(batch)
    for m in (is_list, is_stream):
        got = float(m.compute()[0])
        assert _rel(got, golden["torch_is"]) <= 1e-10
        assert _rel(got, golden["repo_is_list"]) <= 1e-10

    ext = InceptionV3FeatureExtractor(weights_path=pth, dtype=torch.float64)
    kid = KernelInceptionDistance(feature_extractor=ext, subsets=2, subset_size=n, device="cpu")
    kid.update(torch.from_numpy(real), real=True)
    kid.update(torch.from_numpy(fake), real=False)
    mean, std = (float(v) for v in kid.compute())
    assert _rel(mean, golden["torch_kid"]) <= 1e-5 and _rel(mean, golden["repo_kid_mean"]) <= 1e-5
    assert std == golden["repo_kid_std"] == 0.0


@pytest.mark.parametrize("entry", _golden("lpips_end_to_end_golden.json"), ids=lambda e: e["net"])
def test_lpips_matches_the_end_to_end_golden(entry, tmp_path):
    net = entry["net"]
    backbone, lins = _make_lpips_state(net, entry["state_seed"])
    paths = (str(tmp_path / f"{net}_features.pth"), str(tmp_path / f"lpips_{net}.pth"))
    torch.save(backbone, paths[0])
    torch.save(lins, paths[1])
    batches = _lpips_batches(net, entry["img_seed"], entry["n_batches"], entry["batch"], entry["img_hw"])

    net64 = LPIPSNet(net_type=net, weights_path=paths, dtype=torch.float64)
    mean64 = LearnedPerceptualImagePatchSimilarity(net=net64, device="cpu")
    sum64 = LearnedPerceptualImagePatchSimilarity(net=net64, reduction="sum", device="cpu")
    f32 = LearnedPerceptualImagePatchSimilarity(net_type=net, weights_path=paths, device="cpu")
    for img1, img2 in batches:
        for m in (mean64, sum64):
            m.update(torch.from_numpy(img1).double(), torch.from_numpy(img2).double())
        f32.update(torch.from_numpy(img1), torch.from_numpy(img2))
    assert _rel(float(mean64.compute()), entry["torch_mean"]) <= 1e-9
    assert _rel(float(sum64.compute()), entry["torch_sum"]) <= 1e-9
    assert _rel(float(f32.compute()), entry["repo_mean_f32"]) <= 1e-5


# ------------------------------------------------------------------ the converters and the two load paths
@pytest.fixture
def fixed_zip_time(monkeypatch):
    """``np.savez`` stamps each member with the wall clock (2 s resolution):
    one fixed instant makes two files' bytes comparable."""
    monkeypatch.setattr(zipfile.time, "time", lambda: 1_700_000_000.0)


def _jax_tool(name):
    sys.path.insert(0, str(TOOLS))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(TOOLS))


def test_the_inception_converter_writes_the_jax_tools_bytes(inception_pth, tmp_path, fixed_zip_time, capsys):
    _, pth = inception_pth
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    import runpy

    runpy.run_path(str(TOOLS / "torch_convert_inception_weights.py"), run_name="tool")["main"]([pth, ours])
    _jax_tool("convert_inception_weights").main([pth, theirs])
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace("ours", "theirs") == out[2] and out[1].replace("ours", "theirs") == out[3]


def test_a_torchvision_head_warns(inception_pth):
    state = dict(inception_pth[0], **{"fc.weight": torch.zeros(1000, 2048), "fc.bias": torch.zeros(1000)})
    with pytest.warns(UserWarning, match="1000 logits suggests torchvision"):
        flat = inception_net.convert_torch_state_dict(state)
    assert flat["params/Dense_0/kernel"].shape == (2048, 1000)


@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze"])
def test_the_lpips_converter_writes_the_jax_tools_bytes(net, tmp_path, fixed_zip_time):
    torch.manual_seed(0)
    module = lpips_net._LPIPSModule(net)
    state = module.state_dict()
    backbone = {k[len("net."):]: v for k, v in state.items() if k.startswith("net.")}
    lins = {k: v for k, v in state.items() if k.startswith("lin")}
    paths = [str(tmp_path / "b.pth"), str(tmp_path / "l.pth")]
    torch.save(backbone, paths[0])
    torch.save(lins, paths[1])
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    import runpy

    args = ["--net", net, "--backbone", paths[0], "--lins", paths[1]]
    runpy.run_path(str(TOOLS / "torch_convert_lpips_weights.py"), run_name="tool")["main"](args + [ours])
    _jax_tool("convert_lpips_weights").main(args + [theirs])
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    # the pair and the .npz load the same weights
    pair = LPIPSNet(net, weights_path=paths).net.state_dict()
    npz = LPIPSNet(net, weights_path=ours).net.state_dict()
    assert all(torch.equal(pair[k], state[k]) and torch.equal(npz[k], state[k]) for k in state)


def test_the_pth_and_its_npz_give_the_same_features(inception_pth, tmp_path):
    state, pth = inception_pth
    npz = str(tmp_path / "inception.npz")
    inception_net.save_params(npz, inception_net.convert_torch_state_dict(state))
    real, _ = _images(4, 7)
    x = torch.from_numpy(real)
    from_pth = InceptionV3FeatureExtractor(weights_path=pth)(x)
    from_npz = InceptionV3FeatureExtractor(weights_path=npz)(x)
    assert torch.equal(from_pth, from_npz)
    # a wrong layout aborts with the full diff
    bad = {k: v for k, v in state.items() if k != "fc.bias"}
    bad.update({"Mixed_5b.branch1x1.conv.weight": torch.zeros(1, 1, 1, 1), "Mixed_9z.conv.weight": torch.zeros(1)})
    torch.save(bad, str(tmp_path / "bad.pth"))
    with pytest.raises(ValueError, match="does not match InceptionV3") as err:
        InceptionV3FeatureExtractor(weights_path=str(tmp_path / "bad.pth"))
    for part in ("missing ['fc.bias']", "unexpected ['Mixed_9z.conv.weight']",
                 "('Mixed_5b.branch1x1.conv.weight', (1, 1, 1, 1), (64, 192, 1, 1))"):
        assert part in str(err.value)
