"""Functional audio metrics: port of ``metrics_tpu/functional/audio``.

SNR, SI-SNR and SI-SDR are reductions; SDR an FFT correlation and a batched
Toeplitz solve; PIT a search over speaker permutations (on the device below
four speakers, scipy's Hungarian solver on the host from four); STOI a
batched static-shape program; PESQ host code.
"""
from metrics_tpu_torch.functional.audio.pesq import perceptual_evaluation_speech_quality  # noqa: F401
from metrics_tpu_torch.functional.audio.pit import permutation_invariant_training, pit_permutate  # noqa: F401
from metrics_tpu_torch.functional.audio.sdr import (  # noqa: F401
    scale_invariant_signal_distortion_ratio,
    signal_distortion_ratio,
)
from metrics_tpu_torch.functional.audio.snr import (  # noqa: F401
    scale_invariant_signal_noise_ratio,
    signal_noise_ratio,
)
from metrics_tpu_torch.functional.audio.stoi import short_time_objective_intelligibility  # noqa: F401

__all__ = [
    "perceptual_evaluation_speech_quality",
    "permutation_invariant_training",
    "pit_permutate",
    "scale_invariant_signal_distortion_ratio",
    "scale_invariant_signal_noise_ratio",
    "short_time_objective_intelligibility",
    "signal_distortion_ratio",
    "signal_noise_ratio",
]
