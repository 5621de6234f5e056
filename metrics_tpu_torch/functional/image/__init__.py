"""Functional image metrics without a net: port of ``metrics_tpu/functional/image``.

The windowed metrics (SSIM, MS-SSIM, UQI and D-lambda, which is UQI over
band pairs) are depthwise convolutions (``helper._depthwise_conv``); PSNR,
ERGAS and SAM are reductions; ``image_gradients`` is two differences.
"""
from metrics_tpu_torch.functional.image.d_lambda import spectral_distortion_index  # noqa: F401
from metrics_tpu_torch.functional.image.ergas import error_relative_global_dimensionless_synthesis  # noqa: F401
from metrics_tpu_torch.functional.image.gradients import image_gradients  # noqa: F401
from metrics_tpu_torch.functional.image.psnr import peak_signal_noise_ratio  # noqa: F401
from metrics_tpu_torch.functional.image.sam import spectral_angle_mapper  # noqa: F401
from metrics_tpu_torch.functional.image.ssim import (  # noqa: F401
    multiscale_structural_similarity_index_measure,
    structural_similarity_index_measure,
)
from metrics_tpu_torch.functional.image.uqi import universal_image_quality_index  # noqa: F401

__all__ = [
    "error_relative_global_dimensionless_synthesis",
    "image_gradients",
    "multiscale_structural_similarity_index_measure",
    "peak_signal_noise_ratio",
    "spectral_angle_mapper",
    "spectral_distortion_index",
    "structural_similarity_index_measure",
    "universal_image_quality_index",
]
