"""chrF and chrF++: port of ``metrics_tpu/functional/text/chrf.py``.

Character n-grams (order 6 by default) and, for chrF++, word n-grams, an
F-beta score a sentence and order, micro-averaged over the corpus. A
sentence's per-order multiset intersections run in the edit-distance core
(``tm_ngram_overlap``); :func:`_sentence_stats_plain`, the ``Counter`` path,
is its plain version and gives the same bits.
"""
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch import native
from metrics_tpu_torch.functional.text.helper import _float32_on
from metrics_tpu_torch.metric import resolve_device

_EPS = 1e-16

_CHRF_PUNCTUATIONS = set("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")

SentenceStats = Tuple[float, List[float], List[float], List[float]]


def _ngram_counts(tokens: Sequence, n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def _words_and_punctuation(sentence: str) -> List[str]:
    """chrF's word tokens: ONE leading or trailing punctuation character is
    split off each whitespace token (trailing wins when both; one-character
    tokens stay whole; no recursion: ``'...'`` gives ``['..', '.']``)."""
    words: List[str] = []
    for word in sentence.strip().split():
        if len(word) == 1:
            words.append(word)
        elif word[-1] in _CHRF_PUNCTUATIONS:
            words.extend((word[:-1], word[-1]))
        elif word[0] in _CHRF_PUNCTUATIONS:
            words.extend((word[0], word[1:]))
        else:
            words.append(word)
    return words


def _char_and_word_tokens(sentence: str, lowercase: bool, whitespace: bool) -> Tuple[List[str], List[str]]:
    if lowercase:
        sentence = sentence.lower()
    # only the no-whitespace branch strips: with whitespace=True tabs and newlines at the edges stay
    chars = list(sentence) if whitespace else list(sentence.strip().replace(" ", ""))
    return chars, _words_and_punctuation(sentence)


def _char_and_word_ngrams(
    sentence: str, n_char_order: int, n_word_order: int, lowercase: bool, whitespace: bool
) -> Tuple[Dict[int, Counter], Dict[int, Counter]]:
    chars, words = _char_and_word_tokens(sentence, lowercase, whitespace)
    char_ngrams = {n: _ngram_counts(chars, n) for n in range(1, n_char_order + 1)}
    word_ngrams = {n: _ngram_counts(words, n) for n in range(1, n_word_order + 1)}
    return char_ngrams, word_ngrams


def _order_f_scores(
    pred_grams: Dict[int, Counter], tgt_grams: Dict[int, Counter]
) -> Tuple[List[float], List[float], List[float]]:
    """(matching, pred_total, tgt_total) per n-gram order."""
    matching, pred_total, tgt_total = [], [], []
    for n in sorted(pred_grams):
        overlap = pred_grams[n] & tgt_grams[n]
        matching.append(float(sum(overlap.values())))
        pred_total.append(float(sum(pred_grams[n].values())))
        tgt_total.append(float(sum(tgt_grams[n].values())))
    return matching, pred_total, tgt_total


def _window_totals(length: int, max_order: int) -> List[float]:
    """Per-order n-gram counts of a stream of ``length`` symbols: the number of windows."""
    return [float(max(0, length - n + 1)) for n in range(1, max_order + 1)]


def _sentence_stats(
    pred: str,
    tgts: Sequence[str],
    n_char_order: int,
    n_word_order: int,
    lowercase: bool,
    whitespace: bool,
    beta: float,
) -> SentenceStats:
    """A sentence's ``(best_f, matching, pred_total, tgt_total)``.

    The best reference is the first with the STRICTLY greatest F (from 0), so
    where every reference scores 0, or there is none, the matching and target
    counts stay zero while the hypothesis's counts still count. Characters
    are their codepoints and words ids of a vocabulary shared by the
    hypothesis and its references; the core intersects the n-gram multisets
    of every order."""

    def char_ids(sentence: str) -> np.ndarray:
        # codepoints are consistent int32 ids, taken by one encode (a Python loop a character would cost what
        # the Counter path does)
        if lowercase:
            sentence = sentence.lower()
        if not whitespace:
            sentence = sentence.strip().replace(" ", "")
        # surrogatepass: a lone surrogate scores as any other codepoint
        return np.frombuffer(sentence.encode("utf-32-le", "surrogatepass"), dtype=np.int32)

    def word_ids(sentence: str, vocab: Dict[str, int]) -> np.ndarray:
        words = _words_and_punctuation(sentence.lower() if lowercase else sentence)
        return np.fromiter((vocab.setdefault(w, len(vocab)) for w in words), dtype=np.int32, count=len(words))

    vocab_w: Dict[str, int] = {}
    empty = np.zeros(0, dtype=np.int32)
    pc = char_ids(pred)
    pw = word_ids(pred, vocab_w) if n_word_order else empty
    n_orders = n_char_order + n_word_order
    pred_total = _window_totals(len(pc), n_char_order) + _window_totals(len(pw), n_word_order)

    best_f = 0.0
    best_matching = [0.0] * n_orders
    best_tgt = [0.0] * n_orders
    for tgt in tgts:
        tc = char_ids(tgt)
        tw = word_ids(tgt, vocab_w) if n_word_order else empty
        # Python floats, not np.float64: CPython's sum() compensates only on its float fast path, which the
        # Counter path takes, and the two paths must give the same bits
        matching = [float(x) for x in native.ngram_overlap(pc, tc, n_char_order)]
        if n_word_order:
            matching += [float(x) for x in native.ngram_overlap(pw, tw, n_word_order)]
        tgt_total = _window_totals(len(tc), n_char_order) + _window_totals(len(tw), n_word_order)
        f = _chrf_f_score(matching, pred_total, tgt_total, beta)
        if f > best_f:
            best_f, best_matching, best_tgt = f, matching, tgt_total
    return best_f, best_matching, pred_total, best_tgt


def _sentence_stats_plain(
    pred: str,
    tgts: Sequence[str],
    n_char_order: int,
    n_word_order: int,
    lowercase: bool,
    whitespace: bool,
    beta: float,
) -> SentenceStats:
    """:func:`_sentence_stats`'s plain version, with ``Counter``\\ s."""
    n_orders = n_char_order + n_word_order
    p_char, p_word = _char_and_word_ngrams(pred, n_char_order, n_word_order, lowercase, whitespace)
    best_f = 0.0
    best_matching = [0.0] * n_orders
    best_tgt = [0.0] * n_orders
    pred_total = None
    for tgt in tgts:
        t_char, t_word = _char_and_word_ngrams(tgt, n_char_order, n_word_order, lowercase, whitespace)
        m_c, p_c, t_c = _order_f_scores(p_char, t_char)
        m_w, p_w, t_w = _order_f_scores(p_word, t_word)
        matching, pred_total, tgt_total = m_c + m_w, p_c + p_w, t_c + t_w
        f = _chrf_f_score(matching, pred_total, tgt_total, beta)
        if f > best_f:
            best_f, best_matching, best_tgt = f, matching, tgt_total
    if pred_total is None:  # no references at all: the hypothesis counts only
        pred_total = [float(sum(p_char[n].values())) for n in sorted(p_char)]
        pred_total += [float(sum(p_word[n].values())) for n in sorted(p_word)]
    return best_f, best_matching, pred_total, best_tgt


def _chrf_f_score(matching: Sequence[float], pred_total: Sequence[float], tgt_total: Sequence[float],
                  beta: float) -> float:
    """Average F-beta over all n-gram orders (characters and words)."""
    f_scores = []
    for m, p, t in zip(matching, pred_total, tgt_total):
        # a zero total gives a zero precision or recall (only the F's denominator is smoothed), so degenerate
        # orders and empty corpora score 0, not eps
        prec = m / p if p > 0 else 0.0
        rec = m / t if t > 0 else 0.0
        denom = max(beta**2 * prec + rec, _EPS)
        f_scores.append((1 + beta**2) * prec * rec / denom)
    return sum(f_scores) / len(f_scores) if f_scores else 0.0


def _validate_args(n_char_order: int, n_word_order: int, beta: float) -> None:
    if not isinstance(n_char_order, int) or n_char_order < 1:
        raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
    if not isinstance(n_word_order, int) or n_word_order < 0:
        raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
    if beta < 0:
        raise ValueError("Expected argument `beta` to be greater than 0.")


def chrf_score(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    n_char_order: int = 6,
    n_word_order: int = 2,
    beta: float = 2.0,
    lowercase: bool = False,
    whitespace: bool = False,
    return_sentence_level_score: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """chrF (``n_word_order=0``) or chrF++ of a corpus.

    Example:
        >>> from metrics_tpu_torch.functional import chrf_score
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat']]
        >>> round(float(chrf_score(preds, target, device="cpu")), 4)
        0.4942
    """
    _validate_args(n_char_order, n_word_order, beta)
    dev = resolve_device(device)

    preds_ = [preds] if isinstance(preds, str) else list(preds)
    target_ = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")

    n_orders = n_char_order + n_word_order
    total_matching = [0.0] * n_orders
    total_pred = [0.0] * n_orders
    total_tgt = [0.0] * n_orders
    sentence_scores = []

    for pred, tgts in zip(preds_, target_):
        best_f, best_matching, pred_total, best_tgt = _sentence_stats(
            pred, tgts, n_char_order, n_word_order, lowercase, whitespace, beta
        )
        sentence_scores.append(best_f)
        for i in range(n_orders):
            total_matching[i] += best_matching[i]
            total_pred[i] += pred_total[i]
            total_tgt[i] += best_tgt[i]

    corpus_score = torch.full((), _chrf_f_score(total_matching, total_pred, total_tgt, beta), dtype=torch.float32,
                              device=dev)
    if return_sentence_level_score:
        return corpus_score, _float32_on(sentence_scores, dev)
    return corpus_score
