"""Image module metrics: port of ``metrics_tpu/image``.

``PeakSignalNoiseRatio`` keeps sums (or per-slice lists with ``dim``); SSIM,
MS-SSIM, UQI, SAM, ERGAS and D-lambda keep the images as list states and
measure them at ``compute``. FID, KID and IS take features from the bundled
InceptionV3 (:mod:`~metrics_tpu_torch.image.inception_net`) or any extractor,
LPIPS its AlexNet, VGG16 or SqueezeNet network
(:mod:`~metrics_tpu_torch.image.lpips_net`); the nets are ``torch.nn``
modules that load the JAX package's ``.npz`` weights.
"""
from metrics_tpu_torch.image.d_lambda import SpectralDistortionIndex  # noqa: F401
from metrics_tpu_torch.image.ergas import ErrorRelativeGlobalDimensionlessSynthesis  # noqa: F401
from metrics_tpu_torch.image.fid import FrechetInceptionDistance  # noqa: F401
from metrics_tpu_torch.image.inception import InceptionScore  # noqa: F401
from metrics_tpu_torch.image.inception_net import InceptionV3, InceptionV3FeatureExtractor  # noqa: F401
from metrics_tpu_torch.image.kid import KernelInceptionDistance  # noqa: F401
from metrics_tpu_torch.image.lpip import LearnedPerceptualImagePatchSimilarity  # noqa: F401
from metrics_tpu_torch.image.psnr import PeakSignalNoiseRatio  # noqa: F401
from metrics_tpu_torch.image.sam import SpectralAngleMapper  # noqa: F401
from metrics_tpu_torch.image.ssim import (  # noqa: F401
    MultiScaleStructuralSimilarityIndexMeasure,
    StructuralSimilarityIndexMeasure,
)
from metrics_tpu_torch.image.uqi import UniversalImageQualityIndex  # noqa: F401
