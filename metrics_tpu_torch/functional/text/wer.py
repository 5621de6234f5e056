"""Word, character and match error rates and the word-information metrics.

Port of ``metrics_tpu/functional/text/wer.py``: the tokenizing and the edit
distances run on the host, and each update's counts are Python numbers; a
functional's counts reach ``device`` as one float32 copy (the JAX package's
``jnp.asarray`` of each), and the rate is float32 arithmetic there.
"""
from typing import List, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.text.helper import _edit_distances, _float32_on
from metrics_tpu_torch.metric import resolve_device


def _as_list(x: Union[str, List[str]]) -> List[str]:
    return [x] if isinstance(x, str) else list(x)


def _wer_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[float, float]:
    """Edit operations and the reference's word count."""
    preds, target = _as_list(preds), _as_list(target)
    pairs = [(pred.split(), tgt.split()) for pred, tgt in zip(preds, target)]
    errors = sum(_edit_distances(pairs))
    total = sum(len(tgt_tokens) for _, tgt_tokens in pairs)
    return float(errors), float(total)


def _wer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors / total


def _on_device(counts: Tuple[float, ...], device: Optional[Union[str, torch.device]]) -> Tuple[Tensor, ...]:
    return tuple(_float32_on(counts, resolve_device(device)).unbind(0))


def word_error_rate(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[Union[str, torch.device]] = None
) -> Tensor:
    """WER: word edit operations over the reference's words.

    Example:
        >>> from metrics_tpu_torch.functional import word_error_rate
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> float(word_error_rate(preds, target, device="cpu"))
        0.5
    """
    return _wer_compute(*_on_device(_wer_update(preds, target), device))


def _cer_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[float, float]:
    """Character edit operations and the reference's character count."""
    preds, target = _as_list(preds), _as_list(target)
    pairs = [(list(pred), list(tgt)) for pred, tgt in zip(preds, target)]
    errors = sum(_edit_distances(pairs))
    total = sum(len(tgt_tokens) for _, tgt_tokens in pairs)
    return float(errors), float(total)


def _cer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors / total


def char_error_rate(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[Union[str, torch.device]] = None
) -> Tensor:
    """CER: character edit operations over the reference's characters.

    Example:
        >>> from metrics_tpu_torch.functional import char_error_rate
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> round(float(char_error_rate(preds, target, device="cpu")), 4)
        0.3415
    """
    return _cer_compute(*_on_device(_cer_update(preds, target), device))


def _mer_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[float, float]:
    """Edit operations and the sum over pairs of the longer side's word count."""
    preds, target = _as_list(preds), _as_list(target)
    pairs = [(pred.split(), tgt.split()) for pred, tgt in zip(preds, target)]
    errors = sum(_edit_distances(pairs))
    total = sum(max(len(t), len(p)) for p, t in pairs)
    return float(errors), float(total)


def _mer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors / total


def match_error_rate(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[Union[str, torch.device]] = None
) -> Tensor:
    """MER: edit operations over the longer side's words.

    Example:
        >>> from metrics_tpu_torch.functional import match_error_rate
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> round(float(match_error_rate(preds, target, device="cpu")), 4)
        0.4444
    """
    return _mer_compute(*_on_device(_mer_update(preds, target), device))


def _wil_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[float, float, float]:
    """``(errors - total, target words, predicted words)``: the JAX package's
    state convention, in which ``total - errors`` is the hit count."""
    preds, target = _as_list(preds), _as_list(target)
    pairs = [(pred.split(), tgt.split()) for pred, tgt in zip(preds, target)]
    errors = sum(_edit_distances(pairs))
    target_total = sum(len(t) for _, t in pairs)
    preds_total = sum(len(p) for p, _ in pairs)
    total = sum(max(len(t), len(p)) for p, t in pairs)
    return float(errors - total), float(target_total), float(preds_total)


def _wil_compute(errors: Tensor, target_total: Tensor, preds_total: Tensor) -> Tensor:
    return 1 - ((errors / target_total) * (errors / preds_total))


def word_information_lost(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[Union[str, torch.device]] = None
) -> Tensor:
    """WIL: one less the product of the hit shares of both sides.

    Example:
        >>> from metrics_tpu_torch.functional import word_information_lost
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> round(float(word_information_lost(preds, target, device="cpu")), 4)
        0.6528
    """
    return _wil_compute(*_on_device(_wil_update(preds, target), device))


_wip_update = _wil_update


def _wip_compute(errors: Tensor, target_total: Tensor, preds_total: Tensor) -> Tensor:
    return (errors / target_total) * (errors / preds_total)


def word_information_preserved(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[Union[str, torch.device]] = None
) -> Tensor:
    """WIP: the product of the hit shares of both sides.

    Example:
        >>> from metrics_tpu_torch.functional import word_information_preserved
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> round(float(word_information_preserved(preds, target, device="cpu")), 4)
        0.3472
    """
    return _wip_compute(*_on_device(_wip_update(preds, target), device))
