from metrics_tpu_torch.functional.retrieval.metrics import (  # noqa: F401
    retrieval_average_precision,
    retrieval_fall_out,
    retrieval_hit_rate,
    retrieval_normalized_dcg,
    retrieval_precision,
    retrieval_r_precision,
    retrieval_recall,
    retrieval_reciprocal_rank,
)
