from metrics_tpu_torch.functional.classification import (  # noqa: F401
    accuracy,
    average_precision,
    cohen_kappa,
    confusion_matrix,
    jaccard_index,
    matthews_corrcoef,
    precision_recall_curve,
    stat_scores,
)
from metrics_tpu_torch.functional.retrieval import (  # noqa: F401
    retrieval_average_precision,
    retrieval_fall_out,
    retrieval_hit_rate,
    retrieval_normalized_dcg,
    retrieval_precision,
    retrieval_r_precision,
    retrieval_recall,
    retrieval_reciprocal_rank,
)

__all__ = [
    "accuracy",
    "average_precision",
    "cohen_kappa",
    "confusion_matrix",
    "jaccard_index",
    "matthews_corrcoef",
    "precision_recall_curve",
    "retrieval_average_precision",
    "retrieval_fall_out",
    "retrieval_hit_rate",
    "retrieval_normalized_dcg",
    "retrieval_precision",
    "retrieval_r_precision",
    "retrieval_recall",
    "retrieval_reciprocal_rank",
    "stat_scores",
]
