"""PyTorch/CUDA port of ``metrics_tpu``.

The JAX package (``metrics_tpu``) stays the reference; this package
imports neither it nor ``jax``. Metrics keep their states on a CUDA device
unless given ``device="cpu"``; on the card their hot paths run hand-written
kernels (:mod:`metrics_tpu_torch.ops`), on the CPU the kernels' plain
PyTorch versions.
"""
from metrics_tpu_torch import functional  # noqa: F401
from metrics_tpu_torch.classification.accuracy import Accuracy  # noqa: F401
from metrics_tpu_torch.classification.confusion_matrix import ConfusionMatrix  # noqa: F401
from metrics_tpu_torch.classification.stat_scores import StatScores  # noqa: F401
from metrics_tpu_torch.metric import Metric  # noqa: F401

__all__ = ["Accuracy", "ConfusionMatrix", "Metric", "StatScores", "functional"]
