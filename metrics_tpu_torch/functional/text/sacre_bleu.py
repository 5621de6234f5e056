"""SacreBLEU: BLEU with the standard WMT tokenizers.

Port of ``metrics_tpu/functional/text/sacre_bleu.py``. The tokenizers follow
the public mteval-v13a, mteval-v14 (international) and character
specifications; ``'zh'`` separates CJK characters before the 13a rules. The
n-gram statistics and the score are BLEU's (:mod:`.bleu`).
"""
import re
from functools import partial
from typing import Optional, Sequence, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.text.bleu import _bleu_score_compute, _bleu_score_update, _zero_states
from metrics_tpu_torch.utilities.imports import _REGEX_AVAILABLE
from metrics_tpu_torch.metric import resolve_device

AVAILABLE_TOKENIZERS = ("none", "13a", "zh", "intl", "char")

_CJK_RANGES = (
    ("\u3400", "\u4db5"),   # CJK Unified Ideographs Extension A
    ("\u4e00", "\u9fa5"),   # CJK Unified Ideographs
    ("\u9fa6", "\u9fbb"),   # CJK Unified Ideographs, release 4.1
    ("\uf900", "\ufa2d"),   # CJK Compatibility Ideographs
    ("\ufa30", "\ufa6a"),   # CJK Compatibility Ideographs, release 3.2
    ("\ufa70", "\ufad9"),   # CJK Compatibility Ideographs, release 4.1
    ("\U00020000", "\U0002a6d6"),  # CJK Unified Ideographs Extension B
    ("\U0002f800", "\U0002fa1d"),  # CJK Compatibility Supplement
    ("\uff00", "\uffef"),   # Full-width ASCII / half-width kana / Korean alphabet
    ("\u2e80", "\u2eff"),   # CJK Radicals Supplement
    ("\u3000", "\u303f"),   # CJK punctuation marks
    ("\u31c0", "\u31ef"),   # CJK strokes
    ("\u2f00", "\u2fdf"),   # Kangxi Radicals
    ("\u2ff0", "\u2fff"),   # Chinese character structure
    ("\u3100", "\u312f"),   # Phonetic symbols
    ("\u31a0", "\u31bf"),   # Phonetic symbols (Taiwanese/Hakka expansion)
    ("\ufe10", "\ufe1f"),
    ("\ufe30", "\ufe4f"),
    ("\u2600", "\u26ff"),
    ("\u2700", "\u27bf"),
    ("\u3200", "\u32ff"),
    ("\u3300", "\u33ff"),
)

# mteval-v13a language-dependent tokenization rules
_13A_RULES = (
    (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),
)


class _SacreBLEUTokenizer:
    """WMT tokenizer dispatch ('none' | '13a' | 'zh' | 'intl' | 'char')."""

    def __init__(self, tokenize: str, lowercase: bool = False) -> None:
        if tokenize not in AVAILABLE_TOKENIZERS:
            raise ValueError(f"Argument `tokenize` expected to be one of {AVAILABLE_TOKENIZERS} but got {tokenize}.")
        self._fn = getattr(self, f"_tokenize_{'base' if tokenize == 'none' else tokenize}")
        self.lowercase = lowercase

    def __call__(self, line: str) -> Sequence[str]:
        out = self._fn(line)
        return (out.lower() if self.lowercase else out).split()

    @classmethod
    def tokenize(cls, line: str, tokenize: str, lowercase: bool = False) -> Sequence[str]:
        return cls(tokenize, lowercase)(line)

    @staticmethod
    def _apply_rules(line: str) -> str:
        for pattern, repl in _13A_RULES:
            line = pattern.sub(repl, line)
        return " ".join(line.split())

    @staticmethod
    def _tokenize_base(line: str) -> str:
        return line

    @classmethod
    def _tokenize_13a(cls, line: str) -> str:
        line = line.replace("<skipped>", "").replace("-\n", "").replace("\n", " ")
        if "&" in line:
            line = line.replace("&quot;", '"').replace("&amp;", "&").replace("&lt;", "<").replace("&gt;", ">")
        return cls._apply_rules(line)

    @staticmethod
    def _is_chinese_char(uchar: str) -> bool:
        return any(start <= uchar <= end for start, end in _CJK_RANGES)

    @classmethod
    def _tokenize_zh(cls, line: str) -> str:
        out = []
        for char in line.strip():
            if cls._is_chinese_char(char):
                out.append(f" {char} ")
            else:
                out.append(char)
        return cls._apply_rules("".join(out))

    @classmethod
    def _tokenize_intl(cls, line: str) -> str:
        if not _REGEX_AVAILABLE:
            raise ModuleNotFoundError(
                "`intl` tokenization requires the `regex` package: `pip install regex`."
            )
        import regex

        line = regex.sub(r"(\P{N})(\p{P})", r"\1 \2 ", line)
        line = regex.sub(r"(\p{P})(\P{N})", r" \1 \2", line)
        line = regex.sub(r"(\p{S})", r" \1 ", line)
        return " ".join(line.split())

    @staticmethod
    def _tokenize_char(line: str) -> str:
        return " ".join(char for char in line)


def sacre_bleu_score(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    smooth: bool = False,
    tokenize: str = "13a",
    lowercase: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """BLEU after one of the WMT tokenizers: ``'none'``, ``'13a'``, ``'zh'``, ``'intl'`` or ``'char'``.

    Example:
        >>> from metrics_tpu_torch.functional import sacre_bleu_score
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> round(float(sacre_bleu_score(preds, target, device="cpu")), 4)
        0.7598
    """
    if tokenize not in AVAILABLE_TOKENIZERS:
        raise ValueError(f"Argument `tokenize` expected to be one of {AVAILABLE_TOKENIZERS} but got {tokenize}.")
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")

    tokenize_fn = partial(_SacreBLEUTokenizer.tokenize, tokenize=tokenize, lowercase=lowercase)
    numerator, denominator, preds_len, target_len = _bleu_score_update(
        preds, target, *_zero_states(n_gram, resolve_device(device)), n_gram, tokenize_fn
    )
    return _bleu_score_compute(preds_len, target_len, numerator, denominator, n_gram, smooth)
