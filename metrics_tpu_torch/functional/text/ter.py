"""Translation Edit Rate: port of ``metrics_tpu/functional/text/ter.py``.

Tercom's algorithm: tokenize and normalize, then greedy phrase shifts and
Levenshtein edits; TER is edits over the reference's length, the best
reference a sentence, micro-averaged over the corpus. All of it runs on the
host, the candidate shifts' edit distances in batched calls of the core; the
totals and sentence scores reach the device as float32.
"""
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch import native
from metrics_tpu_torch.functional.text.helper import _float32_on
from metrics_tpu_torch.metric import resolve_device

_MAX_SHIFT_SIZE = 10
_MAX_SHIFT_DIST = 50
_SHIFT_CHUNK = 2048

Distances = Callable[[Sequence[Tuple[Sequence, Sequence]]], List[int]]


class _TercomTokenizer:
    """Tercom's normalization."""

    _ASIAN_PUNCTUATION = r"([、。〈-】〔-〟｡-･・])"
    _FULL_WIDTH_PUNCTUATION = r"([．，？：；！＂（）])"

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
    ) -> None:
        self.normalize = normalize
        self.no_punctuation = no_punctuation
        self.lowercase = lowercase
        self.asian_support = asian_support

    def __call__(self, sentence: str) -> str:
        if not sentence:
            return ""
        if self.lowercase:
            sentence = sentence.lower()
        if self.normalize:
            sentence = self._normalize_general_and_western(sentence)
            if self.asian_support:
                sentence = self._normalize_asian(sentence)
        if self.no_punctuation:
            sentence = self._remove_punct(sentence)
            if self.asian_support:
                sentence = self._remove_asian_punct(sentence)
        return " ".join(sentence.split())

    @staticmethod
    def _normalize_general_and_western(sentence: str) -> str:
        sentence = f" {sentence} "
        rules = [
            (r"\n-", ""),
            (r"\n", " "),
            (r"&quot;", '"'),
            (r"&amp;", "&"),
            (r"&lt;", "<"),
            (r"&gt;", ">"),
            (r"([{-~[-` -&(-+:-@/])", r" \1 "),
            (r"'s ", r" 's "),
            (r"'s$", r" 's"),
            # period and comma split off unless next to a digit, a dash after a digit (tercom's rules)
            (r"([^0-9])([\.,])", r"\1 \2 "),
            (r"([\.,])([^0-9])", r" \1 \2"),
            (r"([0-9])(-)", r"\1 \2 "),
        ]
        for pattern, replacement in rules:
            sentence = re.sub(pattern, replacement, sentence)
        return sentence

    @classmethod
    def _normalize_asian(cls, sentence: str) -> str:
        sentence = re.sub(r"([一-鿿㐀-䶿])", r" \1 ", sentence)
        sentence = re.sub(r"([㇀-㇯⺀-⻿])", r" \1 ", sentence)
        sentence = re.sub(r"([㌀-㏿豈-﫿︰-﹏])", r" \1 ", sentence)
        sentence = re.sub(cls._ASIAN_PUNCTUATION, r" \1 ", sentence)
        return re.sub(cls._FULL_WIDTH_PUNCTUATION, r" \1 ", sentence)

    @staticmethod
    def _remove_punct(sentence: str) -> str:
        # tercom's set only: hyphens and apostrophes stay
        return re.sub(r"[\.,\?:;!\"\(\)]", "", sentence)

    @classmethod
    def _remove_asian_punct(cls, sentence: str) -> str:
        sentence = re.sub(cls._ASIAN_PUNCTUATION, "", sentence)
        return re.sub(cls._FULL_WIDTH_PUNCTUATION, "", sentence)


def _find_shifted_candidates(hyp: List[int], ref: List[int]) -> List[Tuple[int, int, int]]:
    """Allowed shifts: (start, length, new_position) of hyp spans that occur in ref."""
    ref_ngrams: Dict[Tuple[int, ...], List[int]] = {}
    for length in range(1, _MAX_SHIFT_SIZE + 1):
        for start in range(len(ref) - length + 1):
            ref_ngrams.setdefault(tuple(ref[start:start + length]), []).append(start)

    candidates = []
    for length in range(1, min(_MAX_SHIFT_SIZE, len(hyp)) + 1):
        for start in range(len(hyp) - length + 1):
            span = tuple(hyp[start:start + length])
            if span not in ref_ngrams:
                continue
            for new_pos in ref_ngrams[span]:
                if abs(start - new_pos) > _MAX_SHIFT_DIST:
                    continue
                candidates.append((start, length, new_pos))
    return candidates


def _apply_shift(hyp: List[int], start: int, length: int, new_pos: int) -> List[int]:
    span = hyp[start:start + length]
    rest = hyp[:start] + hyp[start + length:]
    pos = min(new_pos, len(rest))
    return rest[:pos] + span + rest[pos:]


def _id_distances(pairs: Sequence[Tuple[Sequence[int], Sequence[int]]]) -> List[int]:
    """Edit distances of pairs of int id lists, flattened into one call of the core."""
    return native.levenshtein_batch_ids([a for a, _ in pairs], [b for _, b in pairs]).tolist()


def _ter_edits(hyp_words: List[str], ref_words: List[str], distances: Distances = _id_distances) -> float:
    """Tercom's least edits: the greedy best-shift loop, then the edit distance.

    The words become int ids first (one id a distinct word), so the search
    compares and hashes ints, and the core reads the candidates as they are.
    Each round applies the shift with the largest reduction of the edit
    distance while one reduces it by more than 0 (a shift costs one edit); the
    distance falls every round, so the loop ends. A round's candidates are
    scored in batches of ``distances`` (the core's, or the plain DP's)."""
    vocab: Dict[str, int] = {}
    hyp = [vocab.setdefault(w, len(vocab)) for w in hyp_words]
    ref = [vocab.setdefault(w, len(vocab)) for w in ref_words]
    num_shifts = 0
    current_dist = distances([(hyp, ref)])[0]

    while current_dist > 0:
        best_gain, best_shift = 0, None
        shifts, shifted_hyps = [], []

        def _score_chunk():
            nonlocal best_gain, best_shift
            for shift, dist in zip(shifts, distances([(s, ref) for s in shifted_hyps])):
                gain = current_dist - dist
                if gain > best_gain:
                    best_gain, best_shift = gain, shift
            shifts.clear()
            shifted_hyps.clear()

        for start, length, new_pos in _find_shifted_candidates(hyp, ref):
            shifted = _apply_shift(hyp, start, length, new_pos)
            if shifted == hyp:
                continue
            shifts.append((start, length, new_pos))
            shifted_hyps.append(shifted)
            if len(shifts) >= _SHIFT_CHUNK:  # bounds the candidates held at once on degenerate sentences
                _score_chunk()
        _score_chunk()
        if best_shift is None or best_gain <= 0:
            break
        hyp = _apply_shift(hyp, *best_shift)
        num_shifts += 1
        current_dist -= best_gain

    return float(num_shifts + current_dist)


def _ter_stats(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    tokenizer: _TercomTokenizer,
    distances: Distances = _id_distances,
) -> Tuple[float, float, List[float]]:
    """A corpus's best-reference edits, its average reference lengths and its
    sentence scores, as Python floats."""
    preds_ = [preds] if isinstance(preds, str) else list(preds)
    target_ = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")

    num_edits_total, tgt_len_total = 0.0, 0.0
    sentence_ter: List[float] = []
    for pred, tgts in zip(preds_, target_):
        if not tgts:  # a sentence without references adds nothing and scores 0.0
            sentence_ter.append(0.0)
            continue
        pred_words = tokenizer(pred).split()
        best_num_edits = float("inf")
        tgt_lengths = 0.0
        for tgt in tgts:
            tgt_words = tokenizer(tgt).split()
            tgt_lengths += len(tgt_words)
            # the roles are reversed, as in the JAX package and its reference: shifts move the reference toward
            # the hypothesis, and the shortcut for an empty "reference" fires for an EMPTY HYPOTHESIS (0 edits)
            num_edits = 0.0 if not pred_words else _ter_edits(tgt_words, pred_words, distances)
            if num_edits < best_num_edits:
                best_num_edits = num_edits
        avg_tgt_len = tgt_lengths / len(tgts)

        num_edits_total += best_num_edits
        tgt_len_total += avg_tgt_len
        if avg_tgt_len > 0:
            sentence_ter.append(best_num_edits / avg_tgt_len)
        elif best_num_edits > 0:
            sentence_ter.append(1.0)
        else:
            sentence_ter.append(0.0)
    return num_edits_total, tgt_len_total, sentence_ter


def _ter_compute(total_num_edits: Tensor, total_tgt_length: Tensor) -> Tensor:
    """Edits over length where the length is positive; else 1.0 for edits
    against empty references and 0.0 otherwise (an empty corpus too), selected
    on the device."""
    edits = total_num_edits.to(torch.float32)
    length = total_tgt_length.to(torch.float32)
    return torch.where(length > 0, edits / torch.clamp(length, min=1e-12), torch.where(edits > 0, 1.0, 0.0))


def _validate_flags(normalize: bool, no_punctuation: bool, lowercase: bool, asian_support: bool) -> None:
    if not isinstance(normalize, bool):
        raise ValueError(f"Expected argument `normalize` to be of type boolean but got {normalize}.")
    if not isinstance(no_punctuation, bool):
        raise ValueError(f"Expected argument `no_punctuation` to be of type boolean but got {no_punctuation}.")
    if not isinstance(lowercase, bool):
        raise ValueError(f"Expected argument `lowercase` to be of type boolean but got {lowercase}.")
    if not isinstance(asian_support, bool):
        raise ValueError(f"Expected argument `asian_support` to be of type boolean but got {asian_support}.")


def translation_edit_rate(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    normalize: bool = False,
    no_punctuation: bool = False,
    lowercase: bool = True,
    asian_support: bool = False,
    return_sentence_level_score: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Union[Tensor, Tuple[Tensor, List[Tensor]]]:
    """TER of a corpus; with ``return_sentence_level_score`` also a list of
    the sentences' 0-d scores.

    Example:
        >>> from metrics_tpu_torch.functional import translation_edit_rate
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> round(float(translation_edit_rate(preds, target, device="cpu")), 4)
        0.1538
    """
    _validate_flags(normalize, no_punctuation, lowercase, asian_support)
    dev = resolve_device(device)
    tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
    num_edits, tgt_len, sentence_ter = _ter_stats(preds, target, tokenizer)
    values = _float32_on([num_edits, tgt_len, *sentence_ter], dev).unbind(0)
    total_ter = _ter_compute(values[0], values[1])
    if return_sentence_level_score:
        return total_ter, list(values[2:])
    return total_ter
