"""PerceptualEvaluationSpeechQuality: port of ``metrics_tpu/audio/pesq.py``.

The scores are host code (:mod:`metrics_tpu_torch.functional.audio.pesq`):
the class is ``host_only``, so ``jit_update=True`` warns and runs eagerly.
Only the sum and the count (float32 and int32, the JAX package's states)
live on the metric's device.
"""
from typing import Any

from torch import Tensor

from metrics_tpu_torch.functional.audio.pesq import perceptual_evaluation_speech_quality
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.imports import _PESQ_AVAILABLE


class PerceptualEvaluationSpeechQuality(Metric):
    """Average PESQ MOS-LQO in ``'wb'`` or ``'nb'`` mode over samples.

    ``backend`` chooses the scorer: ``'auto'`` (the compiled ``pesq`` package
    where it can be imported, else the native core with a warning given once),
    ``'pesq'`` (the package; raises at construction where it is absent) or
    ``'native'`` (the core). Package and native scores are not comparable.
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    host_only = True

    def __init__(self, fs: int, mode: str, backend: str = "auto", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if fs not in (8000, 16000):
            raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
        self.fs = fs
        if mode not in ("wb", "nb"):
            raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
        self.mode = mode
        if backend not in ("auto", "pesq", "native"):
            raise ValueError(
                f"Expected argument `backend` to be one of ['auto', 'pesq', 'native'] but got {backend}"
            )
        if backend == "pesq" and not _PESQ_AVAILABLE:
            raise ModuleNotFoundError(
                "PerceptualEvaluationSpeechQuality metric requires that pesq is installed."
                " Either install as `pip install torchmetrics[audio]` or `pip install pesq`."
            )
        self.backend = backend
        self.add_state("sum_pesq", 0.0, dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        scores = perceptual_evaluation_speech_quality(preds, target, self.fs, self.mode, backend=self.backend)
        self.sum_pesq = self.sum_pesq + float(scores.numpy().sum())
        self.total = self.total + scores.numel()

    def compute(self) -> Tensor:
        return self.sum_pesq / self.total
