"""Pairwise similarities and distances: port of ``metrics_tpu/functional/pairwise``."""
from metrics_tpu_torch.functional.pairwise.metrics import (  # noqa: F401
    pairwise_cosine_similarity,
    pairwise_euclidean_distance,
    pairwise_linear_similarity,
    pairwise_manhattan_distance,
)

__all__ = [
    "pairwise_cosine_similarity",
    "pairwise_euclidean_distance",
    "pairwise_linear_similarity",
    "pairwise_manhattan_distance",
]
