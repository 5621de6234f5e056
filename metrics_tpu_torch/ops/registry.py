"""The port's kernels, their launch counts, and the one routing rule.

Port of ``metrics_tpu/ops/registry.py``, cut down to what holds on the card:
a tensor on the CPU takes the kernel's plain PyTorch version, a tensor on a
CUDA device takes the hand-written kernel. There is no opt-in switch and no
fallback: a kernel that fails to build or launch raises.

Each wrapper adds one to its kernel's count where it launches the kernel,
and nowhere else, so a run can show that its path went through the kernels.
"""
from typing import Dict

import torch

KERNELS = ("stat_scores", "confusion_matrix", "binned_stats", "retrieval_sort", "countmin")

_launches: Dict[str, int] = {name: 0 for name in KERNELS}


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on mixed or other devices."""
    device = tensors[0].device
    for t in tensors[1:]:
        if t.device != device:
            raise RuntimeError(f"Expected all tensors to be on the same device, but found {device} and {t.device}")
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel or plain version for tensors on {device}")


def note_launch(name: str) -> None:
    _launches[name] += 1


def launches() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launches`."""
    return dict(_launches)


def reset_launches() -> None:
    for name in _launches:
        _launches[name] = 0
