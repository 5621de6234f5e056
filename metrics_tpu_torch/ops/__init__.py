"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

| kernel | replaces (TPU) | source |
| --- | --- | --- |
| ``stat_scores`` | ``metrics_tpu/ops/stat_scores.py::_stat_counts_kernel`` | ``csrc/stat_scores.cu`` |
| ``confusion_matrix`` | ``metrics_tpu/ops/confusion.py::_confmat_kernel`` | ``csrc/confusion.cu`` |
| ``binned_stats`` | ``metrics_tpu/ops/binned_stats.py::_binned_kernel`` | ``csrc/binned_stats.cu`` |
| ``retrieval_sort`` | ``metrics_tpu/ops/retrieval.py::_rank_sort_kernel`` | ``csrc/retrieval_sort.cu`` |
| ``countmin`` | ``metrics_tpu/ops/sketch_ops.py::_countmin_kernel`` | ``csrc/countmin.cu`` |

:func:`fused_window_tick` (``metrics_tpu/ops/window_tick.py``) is no kernel
but a fused program: one captured CUDA graph of a window's tick.

A CPU tensor takes the plain version, a CUDA tensor the kernel
(:mod:`metrics_tpu_torch.ops.registry`). Nothing is compiled at import: the
kernels are built by ``nvcc`` at their first launch (:mod:`._build`).
"""
from metrics_tpu_torch.ops.binned_stats import binned_stat_scores  # noqa: F401
from metrics_tpu_torch.ops.confusion import confusion_matrix_counts  # noqa: F401
from metrics_tpu_torch.ops.registry import KERNELS, launches, reset_launches  # noqa: F401
from metrics_tpu_torch.ops.retrieval import sorted_by_preds  # noqa: F401
from metrics_tpu_torch.ops.sketch_ops import countmin_update, hash_u32  # noqa: F401
from metrics_tpu_torch.ops.stat_scores import stat_scores_counts  # noqa: F401
from metrics_tpu_torch.ops.window_tick import fused_window_tick  # noqa: F401
