"""Audio module metrics: port of ``metrics_tpu/audio``.

SNR, SI-SNR, SDR, SI-SDR, PIT and STOI update on the metric's device;
PESQ scores on the host (``host_only``). Each keeps the JAX package's
float32 sum and int32 count.
"""
from metrics_tpu_torch.audio.pesq import PerceptualEvaluationSpeechQuality  # noqa: F401
from metrics_tpu_torch.audio.pit import PermutationInvariantTraining  # noqa: F401
from metrics_tpu_torch.audio.sdr import ScaleInvariantSignalDistortionRatio, SignalDistortionRatio  # noqa: F401
from metrics_tpu_torch.audio.snr import ScaleInvariantSignalNoiseRatio, SignalNoiseRatio  # noqa: F401
from metrics_tpu_torch.audio.stoi import ShortTimeObjectiveIntelligibility  # noqa: F401
