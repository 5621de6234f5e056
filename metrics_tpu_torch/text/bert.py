"""BERTScore: port of ``metrics_tpu/text/bert.py``.

Sentences accumulate on the host as Python lists; embedding and matching run
at ``compute``, on the metric's device. There is no tensor state, so nothing
syncs across processes: compute on each process, or gather the text first.
``host_only``.
"""
from typing import Any, Dict, List, Optional, Union

from torch import Tensor

from metrics_tpu_torch.functional.text.bert import EmbedderType, bert_score
from metrics_tpu_torch.metric import Metric


class BERTScore(Metric):
    """BERTScore precision, recall and F1 over accumulated sentence pairs.

    Example (zero-config: the bundled deterministic hash embedder):
        >>> from metrics_tpu_torch import BERTScore
        >>> m = BERTScore(device="cpu")
        >>> m.update(["the cat sat"], ["the cat sat"])
        >>> {k: round(float(v.mean()), 2) for k, v in sorted(m.compute().items())}
        {'f1': 1.0, 'precision': 1.0, 'recall': 1.0}
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    host_only = True

    def __init__(
        self,
        embedder: Optional[EmbedderType] = None,
        model_name_or_path: Optional[str] = None,
        idf: bool = False,
        rescale_with_baseline: bool = False,
        baseline: Optional[Dict[str, float]] = None,
        exclude_special_tokens: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.embedder = embedder
        self.model_name_or_path = model_name_or_path
        self.idf = idf
        self.rescale_with_baseline = rescale_with_baseline
        self.baseline = baseline
        self.exclude_special_tokens = exclude_special_tokens
        self._preds: List[str] = []
        self._target: List[str] = []

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        preds = [preds] if isinstance(preds, str) else list(preds)
        target = [target] if isinstance(target, str) else list(target)
        if len(preds) != len(target):
            raise ValueError("Number of predicted and reference sentences must be the same!")
        self._preds.extend(preds)
        self._target.extend(target)

    def compute(self) -> Dict[str, Tensor]:
        return bert_score(
            self._preds,
            self._target,
            embedder=self.embedder,
            model_name_or_path=self.model_name_or_path,
            idf=self.idf,
            rescale_with_baseline=self.rescale_with_baseline,
            baseline=self.baseline,
            exclude_special_tokens=self.exclude_special_tokens,
            device=self.device,
        )

    def reset(self) -> None:
        super().reset()
        self._preds = []
        self._target = []
