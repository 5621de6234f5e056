"""FID through the port's InceptionV3 as the benchmark's ``fid_inception`` cell runs it, on the CPU at
a small size: the extractor with ``resize=`` against the benchmark's plain reference
(``portbench/references/fid_inception.py``) on its seeded weights loaded as a ``.pth``, FID on the
moment path against the reference's float64 FID, TF1's bilinear resize against hand-worked values, and
the extractor's telemetry counters, and float64 moment sums through the engine.

The cell's images are 256 x 256 resized to 299; here 64 x 64 resized to 96 (the trunk's least input is
75), so that the trunk runs in a second.
"""
import warnings

import pytest
import torch

import metrics_tpu_torch
from metrics_tpu_torch import telemetry
from metrics_tpu_torch.image.inception_net import InceptionV3FeatureExtractor, resize_bilinear_tf1
from portbench.references import fid_inception as reference

SIDE, SIZE = 64, 96


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The reference's seeded state dict and the ``.pth`` it is written to."""
    state = reference.seeded_state_dict(2**31 + 26)
    path = str(tmp_path_factory.mktemp("fid_inception") / "pt_inception_seeded.pth")
    torch.save(state, path)
    return state, path


def _images(n, seed, side=SIDE):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, 3, side, side), generator=g, dtype=torch.uint8)


# float64: the two forwards differ by summation order alone, ~1e-15 of the features' scale over 94
# convolutions; float32: the same arithmetic at 2**-24, with room for the order of cuDNN-free CPU sums
@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-10), (torch.float32, 1e-5)], ids=["float64", "float32"])
def test_extractor_with_resize_matches_the_reference(weights, dtype, rtol):
    state, path = weights
    images = _images(3, 1)
    ext = InceptionV3FeatureExtractor(weights_path=path, resize=SIZE, dtype=dtype)
    got = ext(images)
    want = reference.features(state, [images], "float64" if dtype == torch.float64 else "float32", size=SIZE)
    assert got.dtype == want.dtype == (torch.float64 if dtype == torch.float64 else torch.float32)
    scale = float(want.abs().max())
    assert scale > 0 and float(want.std(0).max()) > 0  # the seeded network's features are live and spread
    assert float((got - want).abs().max()) <= rtol * scale


# float32 sums: the features' mean is ~8 times their spread, so `Σxxᵀ - n μμᵀ` costs each covariance
# entry ~70 float32 roundings of it; with 12 samples of 2048 features the covariances have rank 11, and
# that error in their null space enters tr sqrt(S1 S2) under a square root: FID within 1e-3 of itself
# (measured 1.7e-4). float64 sums (`set_dtype`, as the benchmark cell runs): exact products summed in
# float64, so only the value's float32 rounding is left: within 1e-6 (measured 2.1e-8)
@pytest.mark.parametrize("dtype, rtol", [(torch.float32, 1e-3), (torch.float64, 1e-6)], ids=["float32", "float64"])
def test_fid_on_the_moment_path_matches_the_reference(weights, dtype, rtol):
    state, path = weights
    real, fake = [_images(4, 10 + i) for i in range(3)], [_images(4, 20 + i) for i in range(3)]
    fid = metrics_tpu_torch.FrechetInceptionDistance(
        feature_extractor=InceptionV3FeatureExtractor(weights_path=path, resize=SIZE), feature_dim=2048,
        reset_real_features=False, device="cpu").set_dtype(dtype)
    for x in real:
        fid.update(x, real=True)
    fid.reset()  # the real side is kept
    for x in fake:
        fid.update(x, real=False)
    assert fid.real_outer_sum.dtype == fid.fake_features_sum.dtype == dtype
    got = float(fid.compute())
    mu_r, sigma_r = reference.mean_cov(reference.features(state, real, size=SIZE))
    mu_f, sigma_f = reference.mean_cov(reference.features(state, fake, size=SIZE))
    want = reference.fid(mu_r, sigma_r, mu_f, sigma_f)
    assert reference.effective_rank(sigma_f) > 1.5  # the seeded network's features spread in more than one direction
    assert int(fid.real_num_samples) == 12 and int(fid.fake_num_samples) == 12
    # the means: sums of the float32 features, a few float32 roundings of their scale at most
    mu = fid.fake_features_sum.double() / 12
    assert float((mu - mu_f).abs().max()) <= 1e-6 * float(mu_f.abs().max())
    assert want > 0 and got == pytest.approx(want, rel=rtol)


def test_float64_moments_through_the_engine_are_the_eager_ones():
    """The cell's metric keeps float64 moment sums (``set_dtype``): the engine's programs capture them as
    they are, bit-equal to eager updates, and the real side's survive ``reset()``."""
    g = torch.Generator().manual_seed(26)
    real, fake = [torch.randn(n, 8, generator=g) + 10 for n in (5, 3)], [torch.randn(n, 8, generator=g) + 10.5
                                                                       for n in (5, 5, 3)]
    eager, engine = (metrics_tpu_torch.FrechetInceptionDistance(feature_dim=8, reset_real_features=False,
                                                                jit_update=jit, device="cpu").set_dtype(torch.float64)
                     for jit in (False, True))
    for m in (eager, engine):
        for x in real:
            m.update(x, real=True)
        m.reset()
        for x in fake:
            m.update(x, real=False)
    for key in eager._defaults:
        assert torch.equal(getattr(engine, key), getattr(eager, key)), key
    assert engine.real_outer_sum.dtype == torch.float64 and int(engine.real_num_samples) == 8
    assert engine.dispatch_stats["demotions"] == 0 and engine.dispatch_stats["dispatches"] == 5
    assert float(engine.compute()) == float(eager.compute())


@pytest.mark.parametrize("size, image, want", [
    # 2 -> 3: sources 0, 2/3, 4/3 (the last clamped to pixel 1), across the width and then the height
    (3, [[0.0, 10.0], [20.0, 30.0]],
     [[0.0, 20 / 3, 10.0], [40 / 3, 20.0, 70 / 3], [20.0, 80 / 3, 30.0]]),
    # 3 -> 2: sources 0 and 1.5
    (2, [[0.0, 1.0, 2.0], [3.0, 4.0, 5.0], [6.0, 7.0, 8.0]], [[0.0, 1.5], [4.5, 6.0]]),
], ids=["2to3", "3to2"])
def test_tf1_resize_against_hand_worked_values(size, image, want):
    x = torch.tensor(image).view(1, 1, len(image), len(image))
    got = resize_bilinear_tf1(x, size)[0, 0]
    # the source positions are float32 products, as torch_fidelity's: 2/3 is 0.6666667
    assert torch.allclose(got, torch.tensor(want), rtol=1e-6, atol=0)
    assert torch.equal(got, reference.resize_tf1(x, size)[0, 0])


def test_resize_none_and_images_at_the_size_run_the_trunk_as_before(weights):
    _, path = weights
    plain = InceptionV3FeatureExtractor(weights_path=path)
    images = _images(2, 3, side=SIZE)
    before = plain.net(images.to(torch.float32) / 127.5 - 1.0)[0]  # the extractor's arithmetic before `resize`
    assert torch.equal(plain(images), before)
    assert torch.equal(InceptionV3FeatureExtractor(weights_path=path, resize=SIZE)(images), before)
    with pytest.raises(ValueError, match="resize"):
        InceptionV3FeatureExtractor(resize=32)


def _extract_counts():
    counters = telemetry.snapshot()
    return counters.get("extract:images", 0), counters.get("extract:resized", 0)


@pytest.mark.parametrize("engine", [False, True], ids=["eager", "engine"])
def test_extract_counters_count_images_and_those_resized(weights, engine):
    """Eagerly the extractor ticks ``extract:images`` and ``extract:resized`` itself; through the engine
    the program's ticks ride its ``update`` span, once a call."""
    _, path = weights
    fid = metrics_tpu_torch.FrechetInceptionDistance(
        feature_extractor=InceptionV3FeatureExtractor(weights_path=path, resize=SIZE), feature_dim=2048,
        jit_update=engine, device="cpu")
    telemetry.reset_counters()
    with telemetry.instrument() as session:
        fid.update(_images(3, 4), real=True)
        fid.update(_images(2, 5), real=False)
        fid.update(_images(2, 6, side=SIZE), real=False)  # already at the size: through the trunk, not resized
    assert _extract_counts() == (7, 5)
    if engine:
        spans = session.spans(name="update")
        assert [(s.kind, s.attrs["extract_images"], s.attrs.get("extract_resized")) for s in spans] == [
            ("aot", 3, 3), ("aot", 2, 2), ("aot", 2, None)]


def test_fid_compute_span_names_the_square_root_it_took(weights):
    fid = metrics_tpu_torch.FrechetInceptionDistance(feature_dim=8, device="cpu")
    g = torch.Generator().manual_seed(7)
    fid.update(torch.randn(16, 8, generator=g), real=True)
    fid.update(torch.randn(16, 8, generator=g) + 1, real=False)
    with telemetry.instrument() as session:
        fid.compute()
    (span,) = session.spans(name="compute", owner="FrechetInceptionDistance")
    assert span.attrs["sqrtm_method"] == "eigh"


def test_the_reference_layer_table_is_the_ports_network(weights):
    """The reference's 94 convolutions are the port's, name and shape: its state dict loads strictly."""
    state, _ = weights
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ext = InceptionV3FeatureExtractor()
    assert len(reference.CONVS) == sum(1 for k in state if k.endswith(".conv.weight")) == 94
    ext.net.load_torch_state_dict(state)
    assert all(torch.equal(ext.net.state_dict()[k], v) for k, v in state.items())
