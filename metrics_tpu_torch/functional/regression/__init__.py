"""Functional regression metrics: port of ``metrics_tpu/functional/regression``."""
from metrics_tpu_torch.functional.regression.cosine_similarity import cosine_similarity  # noqa: F401
from metrics_tpu_torch.functional.regression.explained_variance import explained_variance  # noqa: F401
from metrics_tpu_torch.functional.regression.log_mse import mean_squared_log_error  # noqa: F401
from metrics_tpu_torch.functional.regression.mae import mean_absolute_error  # noqa: F401
from metrics_tpu_torch.functional.regression.mape import mean_absolute_percentage_error  # noqa: F401
from metrics_tpu_torch.functional.regression.mse import mean_squared_error  # noqa: F401
from metrics_tpu_torch.functional.regression.pearson import pearson_corrcoef  # noqa: F401
from metrics_tpu_torch.functional.regression.r2 import r2_score  # noqa: F401
from metrics_tpu_torch.functional.regression.spearman import spearman_corrcoef  # noqa: F401
from metrics_tpu_torch.functional.regression.symmetric_mape import (  # noqa: F401
    symmetric_mean_absolute_percentage_error,
)
from metrics_tpu_torch.functional.regression.tweedie_deviance import tweedie_deviance_score  # noqa: F401
from metrics_tpu_torch.functional.regression.wmape import weighted_mean_absolute_percentage_error  # noqa: F401

__all__ = [
    "cosine_similarity",
    "explained_variance",
    "mean_absolute_error",
    "mean_absolute_percentage_error",
    "mean_squared_error",
    "mean_squared_log_error",
    "pearson_corrcoef",
    "r2_score",
    "spearman_corrcoef",
    "symmetric_mean_absolute_percentage_error",
    "tweedie_deviance_score",
    "weighted_mean_absolute_percentage_error",
]
