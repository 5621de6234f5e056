"""CHRFScore: port of ``metrics_tpu/text/chrf.py``.

The states are the JAX package's float32 per-order sums (sum reduce) and,
with sentence scores, a list of ``(1,)`` float32 scores (cat reduce). The
JAX package adds to its sums once a sentence, so past 2**24 the order shows:
an update copies its sentences' counts to the device in one piece and adds
them row by row, in the same order. ``compute`` reads the three sums back in
one piece. ``host_only``.
"""
from typing import Any, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.text.chrf import _chrf_f_score, _sentence_stats, _validate_args
from metrics_tpu_torch.functional.text.helper import _float32_on
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat


class CHRFScore(Metric):
    """chrF or chrF++ with per-order count states.

    Example:
        >>> from metrics_tpu_torch import CHRFScore
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat']]
        >>> chrf = CHRFScore(device="cpu")
        >>> round(float(chrf(preds, target)), 4)
        0.4942
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    host_only = True

    def __init__(
        self,
        n_char_order: int = 6,
        n_word_order: int = 2,
        beta: float = 2.0,
        lowercase: bool = False,
        whitespace: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _validate_args(n_char_order, n_word_order, beta)
        self.n_char_order = n_char_order
        self.n_word_order = n_word_order
        self.beta = beta
        self.lowercase = lowercase
        self.whitespace = whitespace
        self.return_sentence_level_score = return_sentence_level_score

        n_orders = n_char_order + n_word_order
        self.add_state("matching", torch.zeros(n_orders), dist_reduce_fx="sum")
        self.add_state("pred_total", torch.zeros(n_orders), dist_reduce_fx="sum")
        self.add_state("tgt_total", torch.zeros(n_orders), dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_chrf_score", [], dist_reduce_fx="cat")

    def update(self, preds: Sequence[str], target: Sequence[Sequence[str]]) -> None:
        preds_ = [preds] if isinstance(preds, str) else list(preds)
        target_ = [[t] if isinstance(t, str) else list(t) for t in target]

        rows, scores = [], []
        for pred, tgts in zip(preds_, target_):
            f, matching, pred_total, tgt_total = _sentence_stats(
                pred, tgts, self.n_char_order, self.n_word_order, self.lowercase, self.whitespace, self.beta
            )
            rows.append([matching, pred_total, tgt_total])
            scores.append(f)
        if not rows:
            return
        device = self.matching.device
        sums = torch.stack([self.matching, self.pred_total, self.tgt_total])
        for row in _float32_on(rows, device).unbind(0):  # a float32 add a sentence, in order
            sums = sums + row
        self.matching, self.pred_total, self.tgt_total = sums.unbind(0)
        if self.return_sentence_level_score:
            self.sentence_chrf_score.extend(_float32_on(scores, device).reshape(-1, 1).unbind(0))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        matching, pred_total, tgt_total = torch.stack([self.matching, self.pred_total, self.tgt_total]).tolist()
        score = torch.full((), _chrf_f_score(matching, pred_total, tgt_total, self.beta), dtype=torch.float32,
                           device=self.matching.device)
        if self.return_sentence_level_score:
            return score, dim_zero_cat(self.sentence_chrf_score)
        return score
