"""ExtendedEditDistance: port of ``metrics_tpu/text/eed.py``.

The state is the JAX package's list of ``(1,)`` float32 sentence scores (cat
reduce; NaN for a sentence without references), an update's batch copied to
the device in one piece. ``host_only``.
"""
from typing import Any, Sequence, Tuple, Union

from torch import Tensor

from metrics_tpu_torch.functional.text.eed import _eed_compute, _eed_stats, _validate_params
from metrics_tpu_torch.functional.text.helper import _float32_on
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat


class ExtendedEditDistance(Metric):
    """EED over an accumulated corpus (lower is better).

    Example:
        >>> from metrics_tpu_torch import ExtendedEditDistance
        >>> preds = ["this is the prediction", "here is an other sample"]
        >>> target = ["this is the reference", "here is another one"]
        >>> eed = ExtendedEditDistance(device="cpu")
        >>> round(float(eed(preds, target)), 4)
        0.3078
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    host_only = True

    def __init__(
        self,
        language: str = "en",
        return_sentence_level_score: bool = False,
        alpha: float = 2.0,
        rho: float = 0.3,
        deletion: float = 0.2,
        insertion: float = 1.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if language not in ("en", "ja"):
            raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
        self.language = language
        self.return_sentence_level_score = return_sentence_level_score
        _validate_params(alpha, rho, deletion, insertion)
        self.alpha = alpha
        self.rho = rho
        self.deletion = deletion
        self.insertion = insertion

        self.add_state("sentence_eed", [], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        scores = _eed_stats(preds, target, self.language, self.alpha, self.rho, self.deletion, self.insertion)
        if scores:
            self.sentence_eed.extend(_float32_on(scores, self.device).reshape(-1, 1).unbind(0))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        average = _eed_compute(self.sentence_eed, self.device)
        if self.return_sentence_level_score:
            return average, dim_zero_cat(self.sentence_eed)
        return average
