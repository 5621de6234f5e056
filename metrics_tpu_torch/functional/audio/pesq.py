"""PESQ: port of ``metrics_tpu/functional/audio/pesq.py``.

PESQ is host code in both packages: each signal pair is read back to the
host as float32 numpy and scored there, by the compiled ``pesq`` package when
it can be imported, else by the native P.862-structure core
(:mod:`._pesq_core`, the JAX package's core copied, so its scores are the
JAX package's bits). ``backend`` chooses: ``"auto"`` (the package, else the
core with a warning given once a process), ``"pesq"`` (the package or
``ModuleNotFoundError``) or ``"native"`` (the core).
"""
from typing import Any

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.utilities.imports import _PESQ_AVAILABLE
from metrics_tpu_torch.utilities.prints import rank_zero_warn

_warned_native = False


def _backend_pesq(fs: int, target: np.ndarray, preds: np.ndarray, mode: str, backend: str) -> float:
    if backend == "pesq" and not _PESQ_AVAILABLE:
        # an explicit request for the package never silently changes backend
        raise ModuleNotFoundError(
            "PESQ metric requires that pesq is installed."
            " Either install as `pip install torchmetrics[audio]` or `pip install pesq`."
        )
    if backend != "native" and _PESQ_AVAILABLE:
        import pesq as pesq_backend

        return float(pesq_backend.pesq(fs, target, preds, mode))
    if backend == "auto":
        global _warned_native
        if not _warned_native:
            _warned_native = True
            rank_zero_warn(
                "The `pesq` package is not installed; PESQ is computed by the"
                " backend='native' P.862-structure core. Scores follow the ITU"
                " pipeline's behavior but are not bit-calibrated to the ITU"
                " implementation — pass backend='pesq' to require the package"
                " instead, and record which backend produced any number you"
                " compare across environments. See"
                " metrics_tpu_torch/functional/audio/_pesq_core.py for the calibration story."
            )
    from metrics_tpu_torch.functional.audio._pesq_core import pesq_native

    return pesq_native(fs, target, preds, mode)


def _as_host_float32(x: Tensor) -> np.ndarray:
    return x.detach().to("cpu", torch.float32).numpy()


def perceptual_evaluation_speech_quality(
    preds: Tensor,
    target: Tensor,
    fs: int,
    mode: str,
    keep_same_device: bool = False,
    backend: str = "auto",
    **kwargs: Any,
) -> Tensor:
    """PESQ MOS-LQO of ``preds`` against ``target``, both ``[..., time]``:
    float32 of shape ``[...]``, on the CPU (on the inputs' device with
    ``keep_same_device=True``).

    Args:
        preds: degraded signal, shape ``[..., time]``.
        target: reference signal, shape ``[..., time]``.
        fs: sampling frequency, 8000 or 16000 Hz.
        mode: ``'nb'`` (narrow-band) or ``'wb'`` (wide-band).
        keep_same_device: move the scores to the inputs' device.
        backend: ``'auto'``, ``'pesq'`` or ``'native'`` (see the module's
            docstring). Package and native scores are not comparable: pin the
            backend where numbers are compared.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import perceptual_evaluation_speech_quality
        >>> g = torch.Generator().manual_seed(1)
        >>> preds, target = torch.randn(8000, generator=g), torch.randn(8000, generator=g)
        >>> float(perceptual_evaluation_speech_quality(preds, target, 8000, 'nb', backend='native')) > 0
        True
    """
    if fs not in (8000, 16000):
        raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
    if mode not in ("wb", "nb"):
        raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
    if backend not in ("auto", "pesq", "native"):
        raise ValueError(
            f"Expected argument `backend` to be one of ['auto', 'pesq', 'native'] but got {backend}"
        )
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, got {tuple(preds.shape)} and"
            f" {tuple(target.shape)}"
        )
    preds_np = _as_host_float32(preds).reshape(-1, preds.shape[-1])
    target_np = _as_host_float32(target).reshape(-1, target.shape[-1])
    vals = np.array([_backend_pesq(fs, t, p, mode, backend) for t, p in zip(target_np, preds_np)], np.float32)
    out = torch.from_numpy(vals.reshape(preds.shape[:-1]))
    return out.to(preds.device) if keep_same_device else out
