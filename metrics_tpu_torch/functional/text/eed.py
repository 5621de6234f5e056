"""Extended Edit Distance: port of ``metrics_tpu/functional/text/eed.py``.

The published EED (P. Stanchev, W. Wang, H. Ney, "EED: Extended Edit
Distance Measure for Machine Translation", WMT 2019): a CDER-style character
alignment grid with a long jump at blanks, plus a coverage penalty for grid
positions visited more than once. The grid runs in the edit-distance core
(``tm_eed``); :func:`_eed_function_plain`, the numpy grid, is its plain
version. Sentence scores reach the device as float32.
"""
import re
import unicodedata
from math import inf
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch import native
from metrics_tpu_torch.functional.text.helper import _float32_on
from metrics_tpu_torch.metric import resolve_device


def _eed_function(
    hyp: str,
    ref: str,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> float:
    """EED of one sentence pair, through the core."""
    return native.eed_score(hyp, ref, alpha, rho, deletion, insertion)


def _eed_function_plain(
    hyp: str,
    ref: str,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> float:
    """:func:`_eed_function`'s plain version: the grid a reference character at a time in numpy."""
    n = len(hyp)
    visits = np.full(n + 1, -1, dtype=np.int64)
    hyp_chars = np.array(list(hyp)) if n else np.empty(0, dtype="<U1")

    row = np.ones(n + 1, dtype=np.float64)
    row[0] = 0.0  # the grid's origin

    for w in range(1, len(ref) + 1):
        next_row = np.full(n + 1, inf, dtype=np.float64)
        next_row[0] = row[0] + 1.0
        ref_char = ref[w - 1]
        sub = row[:-1] + (hyp_chars != ref_char).astype(np.float64)
        ins = row[1:] + insertion
        base = np.minimum(sub, ins)
        # the left-to-right dependency of deletions, as a scan
        for i in range(1, n + 1):
            next_row[i] = min(next_row[i - 1] + deletion, base[i - 1])

        min_index = int(np.argmin(next_row))
        visits[min_index] += 1

        if ref_char == " ":  # a long jump at a word boundary
            jump = alpha + next_row[min_index]
            next_row = np.minimum(next_row, jump)

        row = next_row

    coverage = rho * float(np.where(visits >= 0, visits, 1).sum())
    return min(1.0, (row[-1] + coverage) / (float(len(ref)) + coverage))


def _preprocess_en(sentence: str) -> str:
    """English preprocessing: punctuation split off, abbreviations and decimals rejoined."""
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    sentence = sentence.rstrip()

    for punct in (".", "!", "?", ","):
        sentence = sentence.replace(punct, f" {punct}")

    rules = [
        (r"\s+", r" "),  # collapse whitespace
        (r"(\d) ([.,]) (\d)", r"\1\2\3"),  # 0 . 1 -> 0.1
        (r"(Dr|Jr|Prof|Rev|Gen|Mr|Mt|Mrs|Ms) .", r"\1."),  # Mr . -> Mr.
    ]
    for pattern, replacement in rules:
        sentence = re.sub(pattern, replacement, sentence)
    return f" {sentence} "  # blanks at both ends allow jumps there


def _preprocess_ja(sentence: str) -> str:
    """Japanese preprocessing: NFKC normalization only."""
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    sentence = sentence.rstrip()
    return unicodedata.normalize("NFKC", sentence)


def _eed_stats(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> List[float]:
    """Each sentence's EED, the best (lowest) over its references, as Python floats.

    A sentence without references has no score: NaN keeps its place, so that
    the sentence scores stay aligned with ``preds``, and the corpus mean
    (``nanmean``) leaves it out."""
    preds_ = [preds] if isinstance(preds, str) else list(preds)
    target_ = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
    if language not in ("en", "ja"):
        raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
    preprocess = _preprocess_en if language == "en" else _preprocess_ja

    scores = []
    for pred, tgts in zip(preds_, target_):
        if not tgts:
            scores.append(float("nan"))
            continue
        hyp = preprocess(pred)
        scores.append(min(_eed_function(hyp, preprocess(t), alpha, rho, deletion, insertion) for t in tgts))
    return scores


def _eed_compute(scores: Union[List[Tensor], Tensor], device: torch.device) -> Tensor:
    """The mean of the finite sentence scores; 0.0 where there is none.

    The scores are a list, or one tensor once a sync has gathered them (the
    JAX package tests such a tensor's truth and raises)."""
    if isinstance(scores, list):
        if not scores:
            return torch.zeros((), dtype=torch.float32, device=device)
        scores = torch.stack(scores)
    return torch.where(torch.isfinite(scores).any(), torch.nanmean(scores), 0.0)


def _validate_params(alpha: float, rho: float, deletion: float, insertion: float) -> None:
    for param, name in [(alpha, "alpha"), (rho, "rho"), (deletion, "deletion"), (insertion, "insertion")]:
        if not isinstance(param, float) or param < 0:
            raise ValueError(f"Parameter `{name}` is expected to be a non-negative float.")


def extended_edit_distance(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    return_sentence_level_score: bool = False,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
    device: Optional[Union[str, torch.device]] = None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """EED of a corpus, lower is better.

    Example:
        >>> from metrics_tpu_torch.functional import extended_edit_distance
        >>> preds = ["this is the prediction", "here is an other sample"]
        >>> target = ["this is the reference", "here is another one"]
        >>> round(float(extended_edit_distance(preds, target, device="cpu")), 4)
        0.3078
    """
    _validate_params(alpha, rho, deletion, insertion)
    dev = resolve_device(device)
    scores = _eed_stats(preds, target, language, alpha, rho, deletion, insertion)
    values = _float32_on(scores, dev)
    average = _eed_compute(list(values.unbind(0)), dev)
    if return_sentence_level_score:
        if not scores:  # the JAX package's stack of no scores
            raise ValueError("Need at least one array to stack.")
        return average, values
    return average
