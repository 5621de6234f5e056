"""SQuAD exact match and F1: port of ``metrics_tpu/functional/text/squad.py``.

The official SQuAD v1.1 evaluation script's semantics. Answers are compared
on the host; an update's F1 and exact-match sums are Python floats and its
question count a Python int, and only they reach the device.
"""
import re
import string
from collections import Counter
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.text.helper import _float32_on, _to_device
from metrics_tpu_torch.metric import resolve_device

PREDS_TYPE = Union[Dict[str, str], List[Dict[str, str]]]
TARGETS_TYPE = Union[Dict[str, Any], List[Dict[str, Any]]]


def _normalize_text(s: str) -> str:
    """Lowercase, strip punctuation/articles/extra whitespace (SQuAD official)."""

    def remove_articles(text: str) -> str:
        return re.sub(r"\b(a|an|the)\b", " ", text)

    def white_space_fix(text: str) -> str:
        return " ".join(text.split())

    def remove_punc(text: str) -> str:
        exclude = set(string.punctuation)
        return "".join(ch for ch in text if ch not in exclude)

    return white_space_fix(remove_articles(remove_punc(s.lower())))


def _get_tokens(s: str) -> List[str]:
    return [] if not s else _normalize_text(s).split()


def _compute_f1_score(prediction: str, ground_truth: str) -> float:
    """Token-overlap F1."""
    pred_toks = _get_tokens(prediction)
    gold_toks = _get_tokens(ground_truth)
    common = Counter(gold_toks) & Counter(pred_toks)
    num_same = sum(common.values())
    if len(gold_toks) == 0 or len(pred_toks) == 0:
        return float(gold_toks == pred_toks)
    if num_same == 0:
        return 0.0
    precision = num_same / len(pred_toks)
    recall = num_same / len(gold_toks)
    return 2 * precision * recall / (precision + recall)


def _compute_exact_match_score(prediction: str, ground_truth: str) -> float:
    return float(_normalize_text(prediction) == _normalize_text(ground_truth))


def _metric_max_over_ground_truths(metric_fn, prediction: str, ground_truths: List[str]) -> float:
    return max(metric_fn(prediction, t) for t in ground_truths)


def _squad_input_check(preds: PREDS_TYPE, targets: TARGETS_TYPE) -> Tuple[Dict[str, str], List[Dict[str, Any]]]:
    """Normalize inputs to {id: prediction} and a SQuAD-format dataset."""
    if isinstance(preds, dict):
        preds = [preds]
    if isinstance(targets, dict):
        targets = [targets]

    for pred in preds:
        keys = pred.keys()
        if "prediction_text" not in keys or "id" not in keys:
            raise KeyError(
                "Expected keys in a single prediction are 'prediction_text' and 'id'."
                " Please make sure that 'prediction_text' maps to the answer string and 'id' maps to the key string."
            )
    for target in targets:
        keys = target.keys()
        if "answers" not in keys or "id" not in keys:
            raise KeyError(
                "Expected keys in a single target are 'answers' and 'id'."
                " Please make sure that 'answers' maps to a `SQuAD` format dictionary and 'id' maps to the key string."
            )
        answers_keys = target["answers"].keys()
        if "text" not in answers_keys:
            raise KeyError(
                "Expected keys in a 'answers' are 'text'."
                " Please make sure that 'text' maps to a list of strings."
            )

    preds_dict = {p["id"]: p["prediction_text"] for p in preds}
    _fn_answer = lambda tgt: {"answers": [{"text": txt} for txt in tgt["answers"]["text"]], "id": tgt["id"]}
    targets_list = [{"paragraphs": [{"qas": [_fn_answer(target) for target in targets]}]}]
    return preds_dict, targets_list


def _squad_update(preds: Dict[str, str], target: List[Dict[str, Any]]) -> Tuple[float, float, int]:
    """The F1 and exact-match sums over the questions, and their count (a
    question without a prediction counts and scores 0)."""
    f1 = 0.0
    exact_match = 0.0
    total = 0
    for article in target:
        for paragraph in article["paragraphs"]:
            for qa in paragraph["qas"]:
                total += 1
                if qa["id"] not in preds:
                    continue
                ground_truths = [x["text"] for x in qa["answers"]]
                pred = preds[qa["id"]]
                exact_match += _metric_max_over_ground_truths(_compute_exact_match_score, pred, ground_truths)
                f1 += _metric_max_over_ground_truths(_compute_f1_score, pred, ground_truths)
    return f1, exact_match, total


def _squad_compute(f1: Tensor, exact_match: Tensor, total: Tensor) -> Dict[str, Tensor]:
    return {"exact_match": 100.0 * exact_match / total, "f1": 100.0 * f1 / total}


def squad(preds: PREDS_TYPE, target: TARGETS_TYPE, device: Optional[Union[str, torch.device]] = None) -> Dict[str, Tensor]:
    """SQuAD exact match and F1, in percent.

    Example:
        >>> from metrics_tpu_torch.functional import squad
        >>> preds = [{"prediction_text": "1976", "id": "56e10a3be3433e1400422b22"}]
        >>> target = [{"answers": {"answer_start": [97], "text": ["1976"]}, "id": "56e10a3be3433e1400422b22"}]
        >>> {k: float(v) for k, v in squad(preds, target, device="cpu").items()}
        {'exact_match': 100.0, 'f1': 100.0}
    """
    preds_dict, target_list = _squad_input_check(preds, target)
    f1, exact_match, total = _squad_update(preds_dict, target_list)
    device = resolve_device(device)
    f1_t, exact_match_t = _float32_on([f1, exact_match], device).unbind(0)
    return _squad_compute(f1_t, exact_match_t, _to_device(torch.tensor(total, dtype=torch.int32), device))
