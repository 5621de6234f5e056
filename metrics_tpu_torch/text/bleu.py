"""BLEUScore and SacreBLEUScore: port of ``metrics_tpu/text/bleu.py``.

The states are the JAX package's float32 n-gram counts and lengths (sum
reduce). An update adds its host counts through one copy to the device;
``compute`` selects the score there and reads nothing back. ``host_only``.
"""
from typing import Any, Sequence

import torch
from torch import Tensor

from metrics_tpu_torch.functional.text.bleu import _bleu_score_compute, _bleu_score_update, _tokenize_fn
from metrics_tpu_torch.functional.text.sacre_bleu import AVAILABLE_TOKENIZERS, _SacreBLEUTokenizer
from metrics_tpu_torch.metric import Metric


class BLEUScore(Metric):
    """Corpus BLEU with n-gram count states.

    Example:
        >>> from metrics_tpu_torch import BLEUScore
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> bleu = BLEUScore(device="cpu")
        >>> round(float(bleu(preds, target)), 4)
        0.7598
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    host_only = True

    def __init__(self, n_gram: int = 4, smooth: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.n_gram = n_gram
        self.smooth = smooth
        self.tokenizer = _tokenize_fn

        self.add_state("preds_len", 0.0, dist_reduce_fx="sum")
        self.add_state("target_len", 0.0, dist_reduce_fx="sum")
        self.add_state("numerator", torch.zeros(self.n_gram), dist_reduce_fx="sum")
        self.add_state("denominator", torch.zeros(self.n_gram), dist_reduce_fx="sum")

    def update(self, preds: Sequence[str], target: Sequence[Sequence[str]]) -> None:
        preds_ = [preds] if isinstance(preds, str) else preds
        target_ = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]
        self.numerator, self.denominator, self.preds_len, self.target_len = _bleu_score_update(
            preds_,
            target_,
            self.numerator,
            self.denominator,
            self.preds_len,
            self.target_len,
            self.n_gram,
            self.tokenizer,
        )

    def compute(self) -> Tensor:
        return _bleu_score_compute(
            self.preds_len, self.target_len, self.numerator, self.denominator, self.n_gram, self.smooth
        )


class SacreBLEUScore(BLEUScore):
    """BLEU after one of the WMT tokenizers.

    Example:
        >>> from metrics_tpu_torch import SacreBLEUScore
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> sacre_bleu = SacreBLEUScore(device="cpu")
        >>> round(float(sacre_bleu(preds, target)), 4)
        0.7598
    """

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        tokenize: str = "13a",
        lowercase: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(n_gram=n_gram, smooth=smooth, **kwargs)
        if tokenize not in AVAILABLE_TOKENIZERS:
            raise ValueError(f"Argument `tokenize` expected to be one of {AVAILABLE_TOKENIZERS} but got {tokenize}.")
        self.tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)
