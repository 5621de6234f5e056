from metrics_tpu_torch.functional.classification import accuracy, confusion_matrix, stat_scores  # noqa: F401

__all__ = ["accuracy", "confusion_matrix", "stat_scores"]
