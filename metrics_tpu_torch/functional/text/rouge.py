"""ROUGE-N, ROUGE-L and ROUGE-Lsum: port of ``metrics_tpu/functional/text/rouge.py``.

The rouge_score package's tokenization (``[a-z0-9]+`` on lowercased text,
optional Porter stemming) and its precision, recall and F-measure. Each
sample's scores are Python floats on the host, the longest common
subsequences come from the edit-distance core (:mod:`metrics_tpu_torch.native`),
and the scores reach ``device`` as one float32 copy, each value rounded once
as ``jnp.asarray`` rounds it. The Python dynamic programs stay only where the
JAX package takes them for reasons of its own: tokens from a custom
tokenizer that cannot be hashed (they need only ``==``), and a summary whose
matrix passes :data:`_NATIVE_LCS_MAX_CELLS`.

rougeLsum splits sentences with nltk's ``sent_tokenize`` where nltk and its
``punkt_tab`` data are already installed, else with the vendored splitter
(:mod:`.sentence_split`). Nothing here downloads anything.
"""
import functools
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch import native
from metrics_tpu_torch.functional.text.helper import _float32_on
from metrics_tpu_torch.functional.text.sentence_split import split_sentences
from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.utilities.imports import _NLTK_AVAILABLE

ALLOWED_ROUGE_KEYS = {
    "rouge1": 1,
    "rouge2": 2,
    "rouge3": 3,
    "rouge4": 4,
    "rouge5": 5,
    "rouge6": 6,
    "rouge7": 7,
    "rouge8": 8,
    "rouge9": 9,
    "rougeL": "L",
    "rougeLsum": "Lsum",
}
ALLOWED_ACCUMULATE_VALUES = ("avg", "best")
SCORE_TYPES = ("fmeasure", "precision", "recall")

# DP matrices beyond this many cells stay on the Python path, as in the JAX package
_NATIVE_LCS_MAX_CELLS = 1 << 27


def _add_newline_to_end_of_each_sentence(x: str, scrub_pegasus_markers: bool = False) -> str:
    """rougeLsum's sentences, one a line. ``scrub_pegasus_markers`` strips
    literal ``"<n>"`` markers first; by default they stay, as in the JAX
    package (and the reference it follows, whose ``re.sub`` discards its
    result)."""
    if scrub_pegasus_markers:
        x = re.sub("<n>", "", x)
    if _punkt_usable():
        import nltk

        return "\n".join(nltk.sent_tokenize(x))
    return "\n".join(split_sentences(x))


@functools.lru_cache(maxsize=1)
def _punkt_usable() -> bool:
    """Whether nltk and its ``punkt_tab`` data are installed (probed once a
    process). Where they are not, the vendored splitter runs: the port never
    downloads the data."""
    if not _NLTK_AVAILABLE:
        return False
    import nltk

    try:
        nltk.data.find("tokenizers/punkt_tab")
    except LookupError:
        return False
    return True


def _normalize_and_tokenize_text(text: str, stemmer: Optional[object] = None) -> List[str]:
    """rouge_score tokenization: lowercase, [a-z0-9]+, optional stemming (>3 chars)."""
    text = re.sub(r"[^a-z0-9]+", " ", text.lower())
    tokens = re.split(r"\s+", text)
    if stemmer is not None:
        tokens = [stemmer.stem(x) if len(x) > 3 else x for x in tokens]
    return [x for x in tokens if (isinstance(x, str) and len(x) > 0)]


def _compute_metrics(hits: int, pred_len: int, target_len: int) -> Dict[str, float]:
    precision = hits / pred_len if pred_len > 0 else 0.0
    recall = hits / target_len if target_len > 0 else 0.0
    if precision + recall > 0:
        fmeasure = 2 * precision * recall / (precision + recall)
    else:
        fmeasure = 0.0
    return {"precision": precision, "recall": recall, "fmeasure": fmeasure}


def _rouge_n_score(pred: List[str], target: List[str], n_gram: int) -> Dict[str, float]:
    """ROUGE-N: clipped n-gram overlap."""

    def _create_ngrams(tokens: List[str], n: int) -> Dict[Tuple, int]:
        ngrams: Dict[Tuple, int] = {}
        for i in range(len(tokens) - n + 1):
            key = tuple(tokens[i:i + n])
            ngrams[key] = ngrams.get(key, 0) + 1
        return ngrams

    pred_ngrams, target_ngrams = _create_ngrams(pred, n_gram), _create_ngrams(target, n_gram)
    pred_len = sum(pred_ngrams.values())
    target_len = sum(target_ngrams.values())
    hits = sum(min(pred_ngrams.get(w, 0), target_ngrams.get(w, 0)) for w in set(pred_ngrams) & set(target_ngrams))
    return _compute_metrics(hits, pred_len, target_len)


def _token_ids(tokens: Sequence, vocab: Dict) -> np.ndarray:
    return np.fromiter((vocab.setdefault(t, len(vocab)) for t in tokens), dtype=np.int32, count=len(tokens))


def _lcs_py(pred_tokens: Sequence, target_tokens: Sequence) -> int:
    """Longest common subsequence length: the row-by-row DP, tokens compared with ``==``."""
    n, m = len(pred_tokens), len(target_tokens)
    prev = np.zeros(m + 1, dtype=np.int64)
    for i in range(1, n + 1):
        cur = np.zeros(m + 1, dtype=np.int64)
        for j in range(1, m + 1):
            if pred_tokens[i - 1] == target_tokens[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = max(prev[j], cur[j - 1])
        prev = cur
    return int(prev[m])


def _lcs(pred_tokens: Sequence, target_tokens: Sequence) -> int:
    """Longest common subsequence length, in the core unless the tokens cannot be hashed."""
    if not pred_tokens or not target_tokens:
        return 0
    vocab: Dict = {}
    try:
        p_ids, t_ids = _token_ids(pred_tokens, vocab), _token_ids(target_tokens, vocab)
    except TypeError:  # a custom tokenizer's unhashable tokens
        return _lcs_py(pred_tokens, target_tokens)
    return native.lcs_ids(p_ids, t_ids)


def _rouge_l_score(pred: List[str], target: List[str]) -> Dict[str, float]:
    """ROUGE-L: the longest common subsequence."""
    if not pred or not target:
        return _compute_metrics(0, len(pred), len(target))
    return _compute_metrics(_lcs(pred, target), len(pred), len(target))


def _union_lcs_py(ref_sent: Sequence, pred_sentences: Sequence[Sequence]) -> int:
    """Reference tokens covered by an LCS with any predicted sentence: the
    full DP matrix and its backtrack, the core's tie-breaking."""
    covered = [False] * len(ref_sent)
    for p_sent in pred_sentences:
        n, m = len(p_sent), len(ref_sent)
        dp = np.zeros((n + 1, m + 1), dtype=np.int64)
        for i in range(1, n + 1):
            for j in range(1, m + 1):
                if p_sent[i - 1] == ref_sent[j - 1]:
                    dp[i, j] = dp[i - 1, j - 1] + 1
                else:
                    dp[i, j] = max(dp[i - 1, j], dp[i, j - 1])
        i, j = n, m
        while i > 0 and j > 0:
            if p_sent[i - 1] == ref_sent[j - 1] and dp[i, j] == dp[i - 1, j - 1] + 1:
                covered[j - 1] = True
                i, j = i - 1, j - 1
            elif dp[i - 1, j] >= dp[i, j - 1]:
                i -= 1
            else:
                j -= 1
    return sum(covered)


def _rouge_lsum_score(pred_sents: List[List[str]], target_sents: List[List[str]]) -> Dict[str, float]:
    """Summary-level ROUGE-L: the union LCS of each reference sentence over
    the predicted sentences (rouge_score's semantics). Ids are made once a
    summary, and the core marks the covered positions."""
    pred_len = sum(len(s) for s in pred_sents)
    target_len = sum(len(s) for s in target_sents)
    if pred_len == 0 or target_len == 0:
        return _compute_metrics(0, pred_len, target_len)

    vocab: Dict = {}
    try:
        pred_ids = [_token_ids(s, vocab) for s in pred_sents if s]
        ref_ids = [_token_ids(s, vocab) for s in target_sents]
    except TypeError:  # a custom tokenizer's unhashable tokens
        pred_ids = None
    max_pred = max((len(p) for p in pred_ids), default=0) if pred_ids is not None else 0
    if pred_ids is None or any((len(r) + 1) * (max_pred + 1) > _NATIVE_LCS_MAX_CELLS for r in ref_ids):
        hits = sum(_union_lcs_py(ref_sent, pred_sents) for ref_sent in target_sents)
        return _compute_metrics(hits, pred_len, target_len)
    hits = 0
    for r_ids in ref_ids:
        if not len(r_ids):
            continue
        covered = np.zeros(len(r_ids), dtype=np.uint8)
        for p_ids in pred_ids:
            native.lcs_union_mark(p_ids, r_ids, covered)
        hits += int(covered.sum())
    return _compute_metrics(hits, pred_len, target_len)


def _rouge_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    rouge_keys_values: List[Union[int, str]],
    accumulate: str,
    stemmer: Optional[object] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
    scrub_pegasus_markers: bool = False,
) -> Dict[Union[int, str], List[Dict[str, float]]]:
    """Each sample's scores a key, as Python floats: the best reference's by
    F-measure (the first on a tie), or the float64 mean over references."""
    results: Dict[Union[int, str], List[Dict[str, float]]] = {k: [] for k in rouge_keys_values}

    for pred_raw, target_raw in zip(preds, target):
        result_inner: Dict[Union[int, str], Dict[str, float]] = {k: {} for k in rouge_keys_values}
        result_avg: Dict[Union[int, str], List[Dict[str, float]]] = {k: [] for k in rouge_keys_values}

        if "Lsum" in rouge_keys_values:
            pred_sents_raw = _add_newline_to_end_of_each_sentence(pred_raw, scrub_pegasus_markers).split("\n")

        pred_tok = (
            list(tokenizer(normalizer(pred_raw) if normalizer else pred_raw))
            if tokenizer
            else _normalize_and_tokenize_text(normalizer(pred_raw) if normalizer else pred_raw, stemmer)
        )

        for tgt_raw in target_raw:
            tgt_tok = (
                list(tokenizer(normalizer(tgt_raw) if normalizer else tgt_raw))
                if tokenizer
                else _normalize_and_tokenize_text(normalizer(tgt_raw) if normalizer else tgt_raw, stemmer)
            )
            for rouge_key in rouge_keys_values:
                if isinstance(rouge_key, int):
                    score = _rouge_n_score(pred_tok, tgt_tok, rouge_key)
                elif rouge_key == "L":
                    score = _rouge_l_score(pred_tok, tgt_tok)
                else:  # Lsum
                    tgt_sents_raw = _add_newline_to_end_of_each_sentence(tgt_raw, scrub_pegasus_markers).split("\n")
                    pred_sents = [_normalize_and_tokenize_text(s, stemmer) for s in pred_sents_raw]
                    tgt_sents = [_normalize_and_tokenize_text(s, stemmer) for s in tgt_sents_raw]
                    score = _rouge_lsum_score(pred_sents, tgt_sents)
                result_avg[rouge_key].append(score)
                if not result_inner[rouge_key] or score["fmeasure"] > result_inner[rouge_key]["fmeasure"]:
                    result_inner[rouge_key] = score

        for rouge_key in rouge_keys_values:
            if accumulate == "best":
                results[rouge_key].append({tp: result_inner[rouge_key][tp] for tp in SCORE_TYPES})
            else:  # avg
                results[rouge_key].append(
                    {tp: float(np.mean([r[tp] for r in result_avg[rouge_key]])) for tp in SCORE_TYPES}
                )
    return results


def _score_rows(
    sentence_results: Dict[Union[int, str], List[Dict[str, float]]], rouge_keys_values: List[Union[int, str]]
) -> Tuple[List[str], List[List[float]]]:
    """The output keys (``rouge1_fmeasure``, ...) and a row of per-sample scores for each."""
    keys, rows = [], []
    for rouge_key in rouge_keys_values:
        for tp in SCORE_TYPES:
            keys.append(f"rouge{rouge_key}_{tp}")
            rows.append([sample[tp] for sample in sentence_results[rouge_key]])
    return keys, rows


def _rouge_score_compute(sentence_results: Dict[str, Union[Tensor, List[Tensor]]], device: torch.device) -> Dict[str, Tensor]:
    """Each key's float32 mean over its samples (0 without any). A key holds
    a list of per-sample tensors, or, after a sync, their concatenation."""
    results: Dict[str, Tensor] = {}
    for rouge_key, scores in sentence_results.items():
        if isinstance(scores, list):
            scores = torch.cat([s.reshape(-1) for s in scores]) if scores else None
        results[rouge_key] = (
            torch.zeros((), dtype=torch.float32, device=device) if scores is None or not scores.numel()
            else scores.reshape(-1).mean()
        )
    return results


def rouge_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    accumulate: str = "best",
    use_stemmer: bool = False,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
    rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
    scrub_pegasus_markers: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, Tensor]:
    """ROUGE scores: each key's precision, recall and F-measure, averaged over samples.

    Example:
        >>> from metrics_tpu_torch.functional import rouge_score
        >>> preds = "My name is John"
        >>> target = "Is your name John"
        >>> result = rouge_score(preds, target, rouge_keys="rouge1", device="cpu")
        >>> round(float(result["rouge1_fmeasure"]), 4)
        0.75
    """
    if use_stemmer and not _NLTK_AVAILABLE:
        raise ModuleNotFoundError("Stemmer requires that `nltk` is installed. Use `pip install nltk`.")
    stemmer = None
    if use_stemmer:
        import nltk

        stemmer = nltk.stem.porter.PorterStemmer()

    if not isinstance(rouge_keys, tuple):
        rouge_keys = (rouge_keys,)
    for key in rouge_keys:
        if key not in ALLOWED_ROUGE_KEYS:
            raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS.keys())}")
    rouge_keys_values = [ALLOWED_ROUGE_KEYS[key] for key in rouge_keys]

    if isinstance(target, list) and all(isinstance(tgt, str) for tgt in target):
        target = [target] if isinstance(preds, str) else [[tgt] for tgt in target]
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [[target]]

    if accumulate not in ALLOWED_ACCUMULATE_VALUES:
        raise ValueError(
            f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE_VALUES}"
        )

    device = resolve_device(device)
    sentence_results = _rouge_score_update(
        preds, target, rouge_keys_values, accumulate, stemmer, normalizer, tokenizer,
        scrub_pegasus_markers=scrub_pegasus_markers,
    )
    keys, rows = _score_rows(sentence_results, rouge_keys_values)
    if not rows[0]:
        return _rouge_score_compute({k: [] for k in keys}, device)
    scores = _float32_on(rows, device)
    return _rouge_score_compute(dict(zip(keys, scores.unbind(0))), device)
