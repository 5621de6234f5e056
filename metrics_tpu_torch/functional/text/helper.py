"""Shared text helpers: edit distance, and host statistics to the device.

Port of ``metrics_tpu/functional/text/helper.py``. The text metrics run on
the host: strings never reach the device, only their counts do. The O(n*m)
dynamic program runs in the edit-distance core (:mod:`metrics_tpu_torch.native`);
:func:`_edit_distance_py`, the two-row Python DP, is its plain version and the
path for tokens that cannot be hashed (they need only ``==``).
"""
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch import native


def _tokens_to_ids(*seqs: Sequence) -> List[np.ndarray]:
    """Map token sequences to shared int32 ids (a token's id is its first appearance's rank)."""
    vocab: Dict = {}
    out = []
    for seq in seqs:
        ids = np.empty(len(seq), dtype=np.int32)
        for i, tok in enumerate(seq):
            ids[i] = vocab.setdefault(tok, len(vocab))
        out.append(ids)
    return out


def _edit_distance_py(prediction_tokens: Sequence, reference_tokens: Sequence) -> int:
    """Levenshtein distance between two token sequences (two-row DP)."""
    n, m = len(prediction_tokens), len(reference_tokens)
    if n == 0:
        return m
    if m == 0:
        return n
    prev_row = list(range(m + 1))
    for i, p_tok in enumerate(prediction_tokens, 1):
        cur = [i]
        for j, r_tok in enumerate(reference_tokens, 1):
            cur.append(min(prev_row[j] + 1, cur[j - 1] + 1, prev_row[j - 1] + (p_tok != r_tok)))
        prev_row = cur
    return prev_row[m]


def _edit_distance(prediction_tokens: Sequence, reference_tokens: Sequence) -> int:
    """Levenshtein distance between two token sequences."""
    try:
        a, b = _tokens_to_ids(prediction_tokens, reference_tokens)
    except TypeError:  # unhashable tokens
        return _edit_distance_py(prediction_tokens, reference_tokens)
    return native.levenshtein_ids(a, b)


def _edit_distances(pairs: Sequence[Tuple[Sequence, Sequence]]) -> List[int]:
    """Edit distances of many pairs: one call of the core for the whole batch."""
    if not pairs:
        return []
    try:
        seqs = _tokens_to_ids(*(s for pair in pairs for s in pair))
    except TypeError:  # unhashable tokens
        return [_edit_distance_py(a, b) for a, b in pairs]
    return [int(v) for v in native.levenshtein_batch_ids(seqs[0::2], seqs[1::2])]


def _to_device(host: Tensor, device: torch.device) -> Tensor:
    """A host tensor on ``device``. On a card the one copy goes from pinned
    memory, so the host does not wait for it."""
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def _float32_on(values: Sequence, device: torch.device) -> Tensor:
    """Python floats (or rows of them) as one float32 tensor on ``device``,
    each value rounded as ``jnp.asarray`` rounds it, in one copy."""
    return _to_device(torch.tensor(values, dtype=torch.float32), device)
