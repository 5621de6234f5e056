"""TranslationEditRate: port of ``metrics_tpu/text/ter.py``.

The states are the JAX package's float32 edit and length totals (sum reduce)
and, with sentence scores, a list of ``(1,)`` float32 scores (cat reduce),
whose batch reaches the device in one copy. ``compute`` selects on the
device. ``host_only``.
"""
from typing import Any, Sequence, Tuple, Union

from torch import Tensor

from metrics_tpu_torch.functional.text.helper import _float32_on
from metrics_tpu_torch.functional.text.ter import _TercomTokenizer, _ter_compute, _ter_stats, _validate_flags
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat


class TranslationEditRate(Metric):
    """TER over an accumulated corpus.

    Example:
        >>> from metrics_tpu_torch import TranslationEditRate
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> ter = TranslationEditRate(device="cpu")
        >>> round(float(ter(preds, target)), 4)
        0.1538
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    host_only = True

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _validate_flags(normalize, no_punctuation, lowercase, asian_support)
        self.tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
        self.return_sentence_level_score = return_sentence_level_score

        self.add_state("total_num_edits", 0.0, dist_reduce_fx="sum")
        self.add_state("total_tgt_length", 0.0, dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_ter", [], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        num_edits, tgt_len, sentence = _ter_stats(preds, target, self.tokenizer)
        self.total_num_edits = self.total_num_edits + num_edits
        self.total_tgt_length = self.total_tgt_length + tgt_len
        if self.return_sentence_level_score and sentence:
            self.sentence_ter.extend(_float32_on(sentence, self.total_num_edits.device).reshape(-1, 1).unbind(0))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        ter = _ter_compute(self.total_num_edits, self.total_tgt_length)
        if self.return_sentence_level_score:
            return ter, dim_zero_cat(self.sentence_ter)
        return ter
