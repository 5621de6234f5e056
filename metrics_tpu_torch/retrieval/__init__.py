from metrics_tpu_torch.retrieval.base import RetrievalMetric  # noqa: F401
from metrics_tpu_torch.retrieval.metrics import (  # noqa: F401
    RetrievalFallOut,
    RetrievalHitRate,
    RetrievalMAP,
    RetrievalMRR,
    RetrievalNormalizedDCG,
    RetrievalPrecision,
    RetrievalRecall,
    RetrievalRPrecision,
)
