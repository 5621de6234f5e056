"""Text module metrics: port of ``metrics_tpu/text``. Every class is
``host_only``: its update runs on the host, and the engines refuse it."""
from metrics_tpu_torch.text.bert import BERTScore  # noqa: F401
from metrics_tpu_torch.text.bleu import BLEUScore, SacreBLEUScore  # noqa: F401
from metrics_tpu_torch.text.chrf import CHRFScore  # noqa: F401
from metrics_tpu_torch.text.eed import ExtendedEditDistance  # noqa: F401
from metrics_tpu_torch.text.rouge import ROUGEScore  # noqa: F401
from metrics_tpu_torch.text.squad import SQuAD  # noqa: F401
from metrics_tpu_torch.text.ter import TranslationEditRate  # noqa: F401
from metrics_tpu_torch.text.wer import (  # noqa: F401
    CharErrorRate,
    MatchErrorRate,
    WordErrorRate,
    WordInfoLost,
    WordInfoPreserved,
)
