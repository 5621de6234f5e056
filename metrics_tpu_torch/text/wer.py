"""The edit-distance module metrics: port of ``metrics_tpu/text/wer.py``.

WER, CER, MER, WIL and WIP. The states are the JAX package's float32 sums;
an update adds its host counts as Python numbers, each rounded to float32 as
``jnp.asarray`` rounds it, with no copy to the device. Each class is
``host_only``: ``jit_update=True`` warns and runs eagerly.
"""
from typing import Any, List, Union

from torch import Tensor

from metrics_tpu_torch.functional.text.wer import (
    _cer_compute,
    _cer_update,
    _mer_compute,
    _mer_update,
    _wer_compute,
    _wer_update,
    _wil_compute,
    _wil_update,
    _wip_compute,
    _wip_update,
)
from metrics_tpu_torch.metric import Metric


class _EditRate(Metric):
    """``errors / total`` of edit counts; ``_update`` and ``_compute`` name the rate."""

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    host_only = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", 0.0, dist_reduce_fx="sum")
        self.add_state("total", 0.0, dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        errors, total = type(self)._update(preds, target)
        self.errors = self.errors + errors
        self.total = self.total + total

    def compute(self) -> Tensor:
        return type(self)._compute(self.errors, self.total)


class WordErrorRate(_EditRate):
    """WER over accumulated samples.

    Example:
        >>> from metrics_tpu_torch import WordErrorRate
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> metric = WordErrorRate(device="cpu")
        >>> float(metric(preds, target))
        0.5
    """

    _update, _compute = staticmethod(_wer_update), staticmethod(_wer_compute)


class CharErrorRate(_EditRate):
    """CER over accumulated samples.

    Example:
        >>> from metrics_tpu_torch import CharErrorRate
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> metric = CharErrorRate(device="cpu")
        >>> round(float(metric(preds, target)), 4)
        0.3415
    """

    _update, _compute = staticmethod(_cer_update), staticmethod(_cer_compute)


class MatchErrorRate(_EditRate):
    """MER over accumulated samples.

    Example:
        >>> from metrics_tpu_torch import MatchErrorRate
        >>> m = MatchErrorRate(device="cpu")
        >>> m.update(["the cat sat"], ["the cat sat on the mat"])
        >>> round(float(m.compute()), 4)
        0.5
    """

    _update, _compute = staticmethod(_mer_update), staticmethod(_mer_compute)


class _WordInfo(Metric):
    """The word-information states: ``errors - total`` and both sides' word counts."""

    is_differentiable = False
    full_state_update = False
    host_only = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", 0.0, dist_reduce_fx="sum")
        self.add_state("target_total", 0.0, dist_reduce_fx="sum")
        self.add_state("preds_total", 0.0, dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        errors, target_total, preds_total = type(self)._update(preds, target)
        self.errors = self.errors + errors
        self.target_total = self.target_total + target_total
        self.preds_total = self.preds_total + preds_total

    def compute(self) -> Tensor:
        return type(self)._compute(self.errors, self.target_total, self.preds_total)


class WordInfoLost(_WordInfo):
    """WIL over accumulated samples.

    Example:
        >>> from metrics_tpu_torch import WordInfoLost
        >>> m = WordInfoLost(device="cpu")
        >>> m.update(["the cat sat"], ["the cat sat on the mat"])
        >>> round(float(m.compute()), 4)
        0.5
    """

    higher_is_better = False
    _update, _compute = staticmethod(_wil_update), staticmethod(_wil_compute)


class WordInfoPreserved(_WordInfo):
    """WIP over accumulated samples.

    Example:
        >>> from metrics_tpu_torch import WordInfoPreserved
        >>> m = WordInfoPreserved(device="cpu")
        >>> m.update(["the cat sat"], ["the cat sat on the mat"])
        >>> round(float(m.compute()), 4)
        0.5
    """

    higher_is_better = True
    _update, _compute = staticmethod(_wip_update), staticmethod(_wip_compute)
