"""Rank-zero-only warnings and log lines (port of ``metrics_tpu/utilities/prints.py``).

The rank is ``torch.distributed``'s when a process group is up, else 0.
"""
import logging
import warnings
from functools import wraps
from typing import Any, Callable

import torch

log = logging.getLogger("metrics_tpu_torch")


def _process_index() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def rank_zero_only(fn: Callable) -> Callable:
    @wraps(fn)
    def wrapped_fn(*args: Any, **kwargs: Any) -> Any:
        if _process_index() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped_fn


@rank_zero_only
def rank_zero_warn(message: str, *args: Any, stacklevel: int = 4, **kwargs: Any) -> None:
    warnings.warn(message, *args, stacklevel=stacklevel, **kwargs)


@rank_zero_only
def rank_zero_info(message: str, *args: Any, **kwargs: Any) -> None:
    log.info(message, *args, **kwargs)


@rank_zero_only
def rank_zero_debug(message: str, *args: Any, **kwargs: Any) -> None:
    log.debug(message, *args, **kwargs)
