"""BLEU: port of ``metrics_tpu/functional/text/bleu.py``.

The n-gram counting and clipping run on the host; an update's per-order
numerator and denominator and its two lengths reach the states' device as one
float32 copy. The score is selected on the device (``where``), so a compute
reads nothing back.
"""
from collections import Counter
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.text.helper import _float32_on
from metrics_tpu_torch.metric import resolve_device


def _count_ngram(ngram_input_list: Sequence[str], n_gram: int) -> Counter:
    """Counts of all n-grams up to order ``n_gram``."""
    ngram_counter: Counter = Counter()
    for i in range(1, n_gram + 1):
        for j in range(len(ngram_input_list) - i + 1):
            ngram_counter[tuple(ngram_input_list[j:(i + j)])] += 1
    return ngram_counter


def _tokenize_fn(sentence: str) -> Sequence[str]:
    """Whitespace tokenizer."""
    return sentence.split()


def _bleu_stats(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    tokenizer: Callable[[str], Sequence[str]] = _tokenize_fn,
) -> Tuple[List[float], List[float], float, float]:
    """Clipped n-gram counts of a corpus on the host: ``(numerator,
    denominator, preds_len, target_len)`` as Python floats."""
    target_tok: List[List[Sequence[str]]] = [[tokenizer(line) if line else [] for line in t] for t in target]
    preds_tok: List[Sequence[str]] = [tokenizer(line) if line else [] for line in preds]

    num = [0.0] * n_gram
    den = [0.0] * n_gram
    p_len, t_len = 0.0, 0.0

    for pred, targets in zip(preds_tok, target_tok):
        p_len += len(pred)
        target_len_list = [len(tgt) for tgt in targets]
        target_len_diff = [abs(len(pred) - x) for x in target_len_list]
        t_len += target_len_list[target_len_diff.index(min(target_len_diff))]
        preds_counter = _count_ngram(pred, n_gram)
        target_counter: Counter = Counter()
        for tgt in targets:
            target_counter |= _count_ngram(tgt, n_gram)

        ngram_counter_clip = preds_counter & target_counter
        for counter_clip in ngram_counter_clip:
            num[len(counter_clip) - 1] += ngram_counter_clip[counter_clip]
        for counter in preds_counter:
            den[len(counter) - 1] += preds_counter[counter]
    return num, den, p_len, t_len


def _bleu_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    numerator: Tensor,
    denominator: Tensor,
    preds_len: Tensor,
    target_len: Tensor,
    n_gram: int = 4,
    tokenizer: Callable[[str], Sequence[str]] = _tokenize_fn,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The states after one update: the corpus's counts added in float32."""
    num, den, p_len, t_len = _bleu_stats(preds, target, n_gram, tokenizer)
    counts = _float32_on(num + den, numerator.device)
    return numerator + counts[:n_gram], denominator + counts[n_gram:], preds_len + p_len, target_len + t_len


def _bleu_score_compute(
    preds_len: Tensor,
    target_len: Tensor,
    numerator: Tensor,
    denominator: Tensor,
    n_gram: int = 4,
    smooth: bool = False,
) -> Tensor:
    """Geometric mean of the n-gram precisions times the brevity penalty.

    A zero numerator makes the score 0. It is selected on the device; the
    ones put in its place only feed the lane ``where`` drops."""
    any_zero_ngram = numerator.min() == 0
    safe_numerator = torch.where(any_zero_ngram, torch.ones_like(numerator), numerator)
    safe_denominator = torch.where(any_zero_ngram, torch.ones_like(denominator), denominator)

    if smooth:
        precision_scores = (safe_numerator + 1.0) / (safe_denominator + 1.0)
        precision_scores[0] = safe_numerator[0] / safe_denominator[0]
    else:
        precision_scores = safe_numerator / safe_denominator

    log_precision_scores = (1.0 / n_gram) * torch.log(precision_scores)
    geometric_mean = torch.exp(torch.sum(log_precision_scores))
    brevity_penalty = torch.where(preds_len > target_len, 1.0, torch.exp(1 - (target_len / preds_len)))
    return torch.where(any_zero_ngram, 0.0, brevity_penalty * geometric_mean)


def _zero_states(n_gram: int, device: torch.device) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    zeros = torch.zeros(2 * n_gram + 2, dtype=torch.float32, device=device)
    return zeros[:n_gram], zeros[n_gram:2 * n_gram], zeros[-2], zeros[-1]


def bleu_score(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    n_gram: int = 4,
    smooth: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """BLEU of a corpus against one or more references a sentence.

    Example:
        >>> from metrics_tpu_torch.functional import bleu_score
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> round(float(bleu_score(preds, target, device="cpu")), 4)
        0.7598
    """
    preds_ = [preds] if isinstance(preds, str) else preds
    target_ = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]

    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")

    numerator, denominator, preds_len, target_len = _bleu_score_update(
        preds_, target_, *_zero_states(n_gram, resolve_device(device)), n_gram, _tokenize_fn
    )
    return _bleu_score_compute(preds_len, target_len, numerator, denominator, n_gram, smooth)
