"""Regression module metrics: port of ``metrics_tpu/regression``.

Fixed-shape states throughout (mostly scalar sums; ``PearsonCorrCoef``
keeps streaming moments merged in rank order after a sync), except
``CosineSimilarity`` and ``SpearmanCorrCoef``, which keep the samples as
list states and normalise or rank them at ``compute``. None reaches a
kernel of :mod:`metrics_tpu_torch.ops`.
"""
from metrics_tpu_torch.regression.cosine_similarity import CosineSimilarity  # noqa: F401
from metrics_tpu_torch.regression.explained_variance import ExplainedVariance  # noqa: F401
from metrics_tpu_torch.regression.log_mse import MeanSquaredLogError  # noqa: F401
from metrics_tpu_torch.regression.mae import MeanAbsoluteError  # noqa: F401
from metrics_tpu_torch.regression.mape import MeanAbsolutePercentageError  # noqa: F401
from metrics_tpu_torch.regression.mse import MeanSquaredError  # noqa: F401
from metrics_tpu_torch.regression.pearson import PearsonCorrCoef  # noqa: F401
from metrics_tpu_torch.regression.r2 import R2Score  # noqa: F401
from metrics_tpu_torch.regression.spearman import SpearmanCorrCoef  # noqa: F401
from metrics_tpu_torch.regression.symmetric_mape import SymmetricMeanAbsolutePercentageError  # noqa: F401
from metrics_tpu_torch.regression.tweedie_deviance import TweedieDevianceScore  # noqa: F401
from metrics_tpu_torch.regression.wmape import WeightedMeanAbsolutePercentageError  # noqa: F401

__all__ = [
    "CosineSimilarity",
    "ExplainedVariance",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "PearsonCorrCoef",
    "R2Score",
    "SpearmanCorrCoef",
    "SymmetricMeanAbsolutePercentageError",
    "TweedieDevianceScore",
    "WeightedMeanAbsolutePercentageError",
]
