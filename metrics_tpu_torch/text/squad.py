"""SQuAD: port of ``metrics_tpu/text/squad.py``.

The states are the JAX package's: ``f1_score`` and ``exact_match`` as
float32 sums and ``total`` as an int32 count. An update adds its host sums
as Python numbers, each rounded to float32 as ``jnp.asarray`` rounds it,
with no copy to the device. ``host_only``.
"""
from typing import Any, Dict

from torch import Tensor

from metrics_tpu_torch.functional.text.squad import (
    PREDS_TYPE,
    TARGETS_TYPE,
    _squad_compute,
    _squad_input_check,
    _squad_update,
)
from metrics_tpu_torch.metric import Metric


class SQuAD(Metric):
    """SQuAD exact match and F1 over accumulated question-answer pairs.

    Example:
        >>> from metrics_tpu_torch import SQuAD
        >>> preds = [{"prediction_text": "1976", "id": "56e10a3be3433e1400422b22"}]
        >>> target = [{"answers": {"answer_start": [97], "text": ["1976"]}, "id": "56e10a3be3433e1400422b22"}]
        >>> squad = SQuAD(device="cpu")
        >>> {k: float(v) for k, v in squad(preds, target).items()}
        {'exact_match': 100.0, 'f1': 100.0}
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    host_only = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("f1_score", 0.0, dist_reduce_fx="sum")
        self.add_state("exact_match", 0.0, dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: PREDS_TYPE, target: TARGETS_TYPE) -> None:
        preds_dict, target_list = _squad_input_check(preds, target)
        f1, exact_match, total = _squad_update(preds_dict, target_list)
        self.f1_score = self.f1_score + f1
        self.exact_match = self.exact_match + exact_match
        self.total = self.total + total

    def compute(self) -> Dict[str, Tensor]:
        return _squad_compute(self.f1_score, self.exact_match, self.total)
