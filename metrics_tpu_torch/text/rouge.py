"""ROUGEScore: port of ``metrics_tpu/text/rouge.py``.

One list state a key and score type (``rouge1_fmeasure``, ...), ``cat``
reduced, holding a ``(1,)`` float32 tensor a sample as the JAX package does.
An update copies its batch's scores to the device as one float32 buffer and
splits it into those ``(1,)`` views, so a batch costs one copy whatever its
size. ``host_only``.

The JAX package's constructor raises without ``nltk`` whenever ``rougeLsum``
is asked for, although its functional splits sentences without nltk; the
port raises only for ``use_stemmer=True``, which does need nltk (ROADMAP.md
Queue C).
"""
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

from torch import Tensor

from metrics_tpu_torch.functional.text.helper import _float32_on
from metrics_tpu_torch.functional.text.rouge import (
    ALLOWED_ACCUMULATE_VALUES,
    ALLOWED_ROUGE_KEYS,
    SCORE_TYPES,
    _rouge_score_compute,
    _rouge_score_update,
    _score_rows,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.imports import _NLTK_AVAILABLE


class ROUGEScore(Metric):
    """ROUGE-N, ROUGE-L and ROUGE-Lsum over accumulated samples.

    Example:
        >>> from metrics_tpu_torch import ROUGEScore
        >>> preds = "My name is John"
        >>> target = "Is your name John"
        >>> rouge = ROUGEScore(rouge_keys="rouge1", device="cpu")
        >>> round(float(rouge(preds, target)["rouge1_fmeasure"]), 4)
        0.75
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    host_only = True

    def __init__(
        self,
        use_stemmer: bool = False,
        normalizer: Optional[Callable[[str], str]] = None,
        tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
        accumulate: str = "best",
        rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
        scrub_pegasus_markers: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if use_stemmer and not _NLTK_AVAILABLE:
            raise ModuleNotFoundError("Stemmer requires that `nltk` is installed. Use `pip install nltk`.")
        if not isinstance(rouge_keys, tuple):
            rouge_keys = (rouge_keys,)
        for key in rouge_keys:
            if key not in ALLOWED_ROUGE_KEYS:
                raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS.keys())}")
        if accumulate not in ALLOWED_ACCUMULATE_VALUES:
            raise ValueError(
                f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE_VALUES}"
            )

        self.rouge_keys = rouge_keys
        self.rouge_keys_values = [ALLOWED_ROUGE_KEYS[key] for key in rouge_keys]
        if use_stemmer:
            import nltk

            self.stemmer = nltk.stem.porter.PorterStemmer()
        else:
            self.stemmer = None
        self.normalizer = normalizer
        self.tokenizer = tokenizer
        self.accumulate = accumulate
        self.scrub_pegasus_markers = scrub_pegasus_markers

        for rouge_key in self.rouge_keys:
            for score in SCORE_TYPES:
                self.add_state(f"{rouge_key}_{score}", [], dist_reduce_fx="cat")

    def update(
        self,
        preds: Union[str, Sequence[str]],
        target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    ) -> None:
        if isinstance(target, list) and all(isinstance(tgt, str) for tgt in target):
            target = [target] if isinstance(preds, str) else [[tgt] for tgt in target]
        if isinstance(preds, str):
            preds = [preds]
        if isinstance(target, str):
            target = [[target]]

        output = _rouge_score_update(
            preds,
            target,
            self.rouge_keys_values,
            accumulate=self.accumulate,
            stemmer=self.stemmer,
            normalizer=self.normalizer,
            tokenizer=self.tokenizer,
            scrub_pegasus_markers=self.scrub_pegasus_markers,
        )
        keys, rows = _score_rows(output, self.rouge_keys_values)
        if not rows[0]:
            return
        # one copy for the batch; each sample's (1,) tensor is a view of it
        scores = _float32_on(rows, self.device)
        for key, row in zip(keys, scores.unbind(0)):
            getattr(self, key).extend(row.reshape(-1, 1).unbind(0))

    def compute(self) -> Dict[str, Tensor]:
        update_output = {
            f"rouge{rouge_key}_{tp}": getattr(self, f"rouge{rouge_key}_{tp}")
            for rouge_key in self.rouge_keys_values
            for tp in SCORE_TYPES
        }
        return _rouge_score_compute(update_output, self.device)
