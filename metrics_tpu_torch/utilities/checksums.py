"""Checkpoint checksums in the JAX package's format.

A ``state_dict`` payload carries one flat ``__checksum__::<key>`` string per
array entry: ``crc32:<8 hex>:<shape joined by x>:<numpy dtype name>``, over
the C-ordered bytes of the leaf (``metrics_tpu/resilience.py:311-341``). The
port keeps its own copy of that format so that a payload written by either
package verifies in the other.
"""
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from metrics_tpu_torch.utilities.exceptions import StateCorruptionError

CHECKSUM_PREFIX = "__checksum__::"


def _host_array(value: Any) -> Optional[np.ndarray]:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, str) or not hasattr(value, "dtype"):
        return None
    return np.asarray(value)


def leaf_checksum(value: Any) -> Optional[str]:
    arr = _host_array(value)
    if arr is None:
        return None
    crc = zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF
    return f"crc32:{crc:08x}:{'x'.join(str(d) for d in arr.shape)}:{arr.dtype}"


def attach_checksums(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Add a checksum entry for every array entry of ``payload`` (in place)."""
    sums = {}
    for key, value in payload.items():
        if str(key).startswith(CHECKSUM_PREFIX):
            continue
        digest = leaf_checksum(value)
        if digest is not None:
            sums[f"{CHECKSUM_PREFIX}{key}"] = digest
    payload.update(sums)
    return payload


def verify_checksums(payload: Dict[str, Any]) -> None:
    """Raise :class:`StateCorruptionError` naming the first entry whose
    checksum does not match. Payloads without checksums pass."""
    for key, expected in payload.items():
        key = str(key)
        if not key.startswith(CHECKSUM_PREFIX):
            continue
        target = key[len(CHECKSUM_PREFIX):]
        if target not in payload:
            raise StateCorruptionError(f"checkpoint payload has a checksum for '{target}' but no such entry")
        actual = leaf_checksum(payload[target])
        expected = expected if isinstance(expected, str) else str(expected)
        if actual is not None and actual != expected:
            raise StateCorruptionError(
                f"checkpoint state entry '{target}' failed its integrity check "
                f"(stored {expected}, restored payload hashes to {actual})"
            )
