"""The port's kernels, their launch counts, and the one routing rule.

Port of ``metrics_tpu/ops/registry.py``, cut down to what holds on the card:
a tensor on the CPU takes the kernel's plain PyTorch version, a tensor on a
CUDA device takes the hand-written kernel. There is no opt-in switch and no
fallback: a kernel that fails to build or launch raises.

Each wrapper adds one to its kernel's count where it launches the kernel,
and nowhere else, so a run can show that its path went through the kernels.
It names the branch it launched and the shape it launched at; those counts
are kept per ``(branch, shape)`` beside the total.

A launch made while a CUDA graph is captured runs nothing then: inside
:func:`recording` it is written down instead of counted, and the engine adds
the written launches again on every replay of that graph
(:func:`note_replay`), so the counts stay the kernels run on the card.
"""
import ctypes
from contextlib import contextmanager
from typing import Dict, Iterator, List, Tuple

import torch

KERNELS = ("stat_scores", "confusion_matrix", "binned_stats", "retrieval_sort", "countmin")

_launches: Dict[str, int] = {name: 0 for name in KERNELS}
_by_shape: Dict[str, Dict[Tuple[str, Tuple[int, ...]], int]] = {name: {} for name in KERNELS}
_limits: Dict[torch.device, Tuple[int, int]] = {}
# the launch lists of the captures under way, innermost last
_recordings: List[List[Tuple[str, str, Tuple[int, ...]]]] = []


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


def note_launch(name: str, branch: str, shape: Tuple[int, ...]) -> None:
    if _recordings:
        _recordings[-1].append((name, branch, tuple(shape)))
        return
    _count(name, branch, tuple(shape))


def _count(name: str, branch: str, shape: Tuple[int, ...]) -> None:
    _launches[name] += 1
    _by_shape[name][(branch, shape)] = _by_shape[name].get((branch, shape), 0) + 1


@contextmanager
def recording() -> Iterator[List[Tuple[str, str, Tuple[int, ...]]]]:
    """Write down, and do not count, the launches of the block (a capture)."""
    launched: List[Tuple[str, str, Tuple[int, ...]]] = []
    _recordings.append(launched)
    try:
        yield launched
    finally:
        _recordings.remove(launched)


def note_replay(launched: List[Tuple[str, str, Tuple[int, ...]]]) -> None:
    """Count the launches a replayed graph ran."""
    for name, branch, shape in launched:
        _count(name, branch, shape)


def launches() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launches`."""
    return dict(_launches)


def launches_by_shape(name: str) -> Dict[Tuple[str, Tuple[int, ...]], int]:
    """Launches of kernel ``name`` per ``(branch, shape)`` since the last
    :func:`reset_launches`."""
    return dict(_by_shape[name])


def reset_launches() -> None:
    for name in _launches:
        _launches[name] = 0
        _by_shape[name].clear()


def device_limits(device: torch.device, lib: ctypes.CDLL, name: str) -> Tuple[int, int]:
    """The SM count and the opt-in shared memory a block may use on CUDA
    ``device``, from which the launch plans size their grids; read once
    through the ``<name>_device`` export of the kernel library ``lib``
    (``csrc/device.cuh``)."""
    device = torch.device(device)
    if device not in _limits:
        sms, shared = ctypes.c_int(0), ctypes.c_int(0)
        query = getattr(lib, f"{name}_device")
        query.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        query.restype = ctypes.c_int
        with torch.cuda.device(device):
            err = query(ctypes.byref(sms), ctypes.byref(shared))
        if err != 0:
            message = getattr(lib, f"{name}_error_string")(err).decode()
            raise RuntimeError(f"{name}: cannot read the device's limits: {message}")
        _limits[device] = (sms.value, shared.value)
    return _limits[device]
