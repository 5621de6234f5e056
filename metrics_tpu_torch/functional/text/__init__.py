"""Functional text metrics: port of ``metrics_tpu/functional/text``.

The error rates, BLEU and SacreBLEU, chrF, TER, EED, ROUGE, SQuAD and
BERTScore. Strings stay on the host, where the edit-distance core
(:mod:`metrics_tpu_torch.native`) runs their dynamic programs; only counts,
scores and BERTScore's embeddings reach the device. Each functional takes
``device`` (``cuda`` unless given), since it has no tensor input to take one
from.
"""
from metrics_tpu_torch.functional.text.bert import bert_score  # noqa: F401
from metrics_tpu_torch.functional.text.bleu import bleu_score  # noqa: F401
from metrics_tpu_torch.functional.text.chrf import chrf_score  # noqa: F401
from metrics_tpu_torch.functional.text.eed import extended_edit_distance  # noqa: F401
from metrics_tpu_torch.functional.text.rouge import rouge_score  # noqa: F401
from metrics_tpu_torch.functional.text.sacre_bleu import sacre_bleu_score  # noqa: F401
from metrics_tpu_torch.functional.text.squad import squad  # noqa: F401
from metrics_tpu_torch.functional.text.ter import translation_edit_rate  # noqa: F401
from metrics_tpu_torch.functional.text.wer import (  # noqa: F401
    char_error_rate,
    match_error_rate,
    word_error_rate,
    word_information_lost,
    word_information_preserved,
)

__all__ = [
    "bert_score",
    "bleu_score",
    "char_error_rate",
    "chrf_score",
    "extended_edit_distance",
    "match_error_rate",
    "rouge_score",
    "sacre_bleu_score",
    "squad",
    "translation_edit_rate",
    "word_error_rate",
    "word_information_lost",
    "word_information_preserved",
]
