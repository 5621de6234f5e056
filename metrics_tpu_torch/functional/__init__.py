from metrics_tpu_torch.functional.classification import (  # noqa: F401
    accuracy,
    average_precision,
    confusion_matrix,
    precision_recall_curve,
    stat_scores,
)

__all__ = ["accuracy", "average_precision", "confusion_matrix", "precision_recall_curve", "stat_scores"]
