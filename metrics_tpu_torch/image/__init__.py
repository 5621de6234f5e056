"""Image module metrics without a net: port of ``metrics_tpu/image`` less FID,
IS, KID, LPIPS and their nets (ROADMAP.md Queue A item 12e).

``PeakSignalNoiseRatio`` keeps sums (or per-slice lists with ``dim``); the
others keep the images as list states and measure them at ``compute``.
"""
from metrics_tpu_torch.image.d_lambda import SpectralDistortionIndex  # noqa: F401
from metrics_tpu_torch.image.ergas import ErrorRelativeGlobalDimensionlessSynthesis  # noqa: F401
from metrics_tpu_torch.image.psnr import PeakSignalNoiseRatio  # noqa: F401
from metrics_tpu_torch.image.sam import SpectralAngleMapper  # noqa: F401
from metrics_tpu_torch.image.ssim import (  # noqa: F401
    MultiScaleStructuralSimilarityIndexMeasure,
    StructuralSimilarityIndexMeasure,
)
from metrics_tpu_torch.image.uqi import UniversalImageQualityIndex  # noqa: F401
