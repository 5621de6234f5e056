"""TP/FP/TN/FN statistics: port of ``metrics_tpu/functional/classification/stat_scores.py``.

* ``(B, C)`` float scores against ``(B,)`` integer labels with a micro or
  macro reduce take :func:`_fast_multiclass_stat_scores`, which never builds
  the ``(B, C)`` one-hots. The macro reduce gets its per-class counts from
  the ``stat_scores`` kernel.
* A negative ``ignore_index`` is folded into a row mask for the micro/macro
  reduces; the per-sample reduces drop the rows.
* ``sample_mask`` makes masked rows count zero in every sum.

Counts are int32, as the JAX package gives them with x64 off.
"""
from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.ops import stat_scores_counts
from metrics_tpu_torch.utilities.checks import (
    _check_classification_inputs,
    _input_format_classification,
    _is_floating,
    _is_integer,
)
from metrics_tpu_torch.utilities.enums import AverageMethod, DataType, MDMCAverageMethod

_COUNT_DTYPE = torch.int32


def _del_column(data: Tensor, idx: int) -> Tensor:
    """Delete column ``idx``."""
    return torch.cat([data[:, :idx], data[:, (idx + 1):]], dim=1)


def _drop_negative_ignored_indices(
    preds: Tensor, target: Tensor, ignore_index: int, mode: DataType
) -> Tuple[Tensor, Tensor]:
    """Remove the rows whose target equals a negative ``ignore_index``."""
    if mode == DataType.MULTIDIM_MULTICLASS and _is_floating(preds):
        num_classes = preds.shape[1]
        preds = torch.movedim(preds, 1, -1).reshape(-1, num_classes)
        target = target.reshape(-1)

    if mode in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS):
        keep = target != ignore_index
        preds = preds[keep]
        target = target[keep]
    return preds, target


def _mask_negative_ignored_indices(
    preds: Tensor,
    target: Tensor,
    ignore_index: int,
    mode: DataType,
    sample_mask: Optional[Tensor],
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """Keep the rows whose target equals the negative ``ignore_index``, set
    their target to a valid class and zero them through the row mask: the same
    sums as dropping them, for the micro/macro reduces."""
    if sample_mask is not None and sample_mask.shape != target.shape:
        sample_mask = sample_mask.reshape(
            tuple(sample_mask.shape) + (1,) * (target.ndim - sample_mask.ndim)
        ).expand(target.shape)

    if mode == DataType.MULTIDIM_MULTICLASS and _is_floating(preds):
        num_classes = preds.shape[1]
        preds = torch.movedim(preds, 1, -1).reshape(-1, num_classes)
        target = target.reshape(-1)
        if sample_mask is not None:
            sample_mask = sample_mask.reshape(-1)

    if mode in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS):
        keep = target != ignore_index
        target = torch.where(keep, target, 0)
        sample_mask = keep if sample_mask is None else (sample_mask & keep)
    return preds, target, sample_mask


def _stat_scores(
    preds: Tensor,
    target: Tensor,
    reduce: Optional[str] = "micro",
    sample_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """tp/fp/tn/fn sums over the dims ``reduce`` implies."""
    dim: Union[int, Tuple[int, ...]] = 1  # "samples"
    if reduce == "micro":
        dim = (0, 1) if preds.ndim == 2 else (1, 2)
    elif reduce == "macro":
        dim = 0 if preds.ndim == 2 else 2

    true_pred, false_pred = target == preds, target != preds
    pos_pred, neg_pred = preds == 1, preds == 0

    if sample_mask is not None:
        mask = sample_mask.reshape((-1,) + (1,) * (preds.ndim - 1)).bool()
        true_pred = true_pred & mask
        false_pred = false_pred & mask

    tp = (true_pred & pos_pred).sum(dim=dim)
    fp = (false_pred & pos_pred).sum(dim=dim)
    tn = (true_pred & neg_pred).sum(dim=dim)
    fn = (false_pred & neg_pred).sum(dim=dim)
    return tp.to(_COUNT_DTYPE), fp.to(_COUNT_DTYPE), tn.to(_COUNT_DTYPE), fn.to(_COUNT_DTYPE)


def _fast_multiclass_eligible(
    preds: Tensor,
    target: Tensor,
    reduce: Optional[str],
    top_k: Optional[int],
    multiclass: Optional[bool],
    num_classes: Optional[int],
) -> bool:
    """Shape/config gate for the one-hot-free multiclass path."""
    return (
        reduce in ("micro", "macro")
        and preds.ndim == 2
        and target.ndim == 1
        and preds.shape[0] == target.shape[0]
        and preds.shape[0] > 0
        and preds.shape[1] > 1
        and _is_floating(preds)
        and _is_integer(target)
        and top_k in (None, 1)
        and multiclass is not False
        and (num_classes is None or num_classes == preds.shape[1])
    )


def _predicted_classes(preds: Tensor) -> Tensor:
    """int32 index of each row's first maximum, taken as max-compare then
    min-index so that ties and NaN rank as in the JAX package (``torch.argmax``
    ranks NaN otherwise). A row holding NaN gets ``C``: no class matches it,
    and the ``stat_scores`` scatter counts it as the JAX package's does."""
    num_classes = preds.shape[1]
    class_idx = torch.arange(num_classes, dtype=torch.int32, device=preds.device)
    row_max = preds.amax(dim=-1, keepdim=True)
    return torch.where(preds == row_max, class_idx, num_classes).amin(dim=-1)


def _fast_multiclass_stat_scores(
    preds: Tensor,
    target: Tensor,
    reduce: str,
    ignore_index: Optional[int],
    sample_mask: Optional[Tensor],
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """tp/fp/tn/fn for ``(B, C)`` float scores against ``(B,)`` int labels.

    The predicted class comes from :func:`_predicted_classes`; the counts
    follow from ``fp[c] = #pred(c) - tp[c]``, ``fn[c] = #target(c) -
    tp[c]``, ``tn[c] = rows - tp - fp - fn``. ``ignore_index`` here is the
    non-negative column variant; a negative one arrives in ``sample_mask``.
    """
    num_rows, num_classes = preds.shape
    pred_cls = _predicted_classes(preds)
    target_cls = target.to(torch.int32)
    correct = pred_cls == target_cls

    if sample_mask is not None:
        valid = sample_mask.bool()
        n_valid = valid.sum()
        correct = correct & valid
    else:
        valid = None
        n_valid = num_rows

    if reduce == "micro":
        # the ignored class falls out of every count and the cells shrink to C-1
        if ignore_index is not None:
            t_ok = target_cls != ignore_index
            p_ok = pred_cls != ignore_index
            if valid is not None:
                t_ok = t_ok & valid
                p_ok = p_ok & valid
            tp = (correct & t_ok).sum()
            fp = p_ok.sum() - tp
            fn = t_ok.sum() - tp
            tn = n_valid * (num_classes - 1) - tp - fp - fn
        else:
            tp = correct.sum()
            fp = n_valid - tp
            fn = n_valid - tp
            tn = n_valid * num_classes - tp - fp - fn
        return tp.to(_COUNT_DTYPE), fp.to(_COUNT_DTYPE), tn.to(_COUNT_DTYPE), fn.to(_COUNT_DTYPE)

    # macro: the three per-class counts come from the stat_scores kernel
    w = valid.to(_COUNT_DTYPE) if valid is not None else torch.ones(num_rows, dtype=_COUNT_DTYPE, device=preds.device)
    targ_count, pred_count, tp = stat_scores_counts(target_cls, pred_cls, correct, w, num_classes)
    fp = pred_count - tp
    fn = targ_count - tp
    tn = (n_valid - tp - fp - fn).to(_COUNT_DTYPE)
    if ignore_index is not None:
        for t in (tp, fp, tn, fn):
            t[ignore_index] = -1
    return tp, fp, tn, fn


def _stat_scores_update(
    preds: Tensor,
    target: Tensor,
    reduce: Optional[str] = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    threshold: float = 0.5,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
    mode: Optional[DataType] = None,
    sample_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Format the inputs and count tp/fp/tn/fn for one batch.

    ``sample_mask`` is an optional per-row validity mask (bool, aligned with
    axis 0): masked rows add nothing to any count. Only the micro/macro
    reduces take it.
    """
    if sample_mask is not None and (reduce == "samples" or mdmc_reduce == "samplewise"):
        raise ValueError(
            "`sample_mask` requires a collapsing reduce; reduce='samples' and"
            " mdmc_reduce='samplewise' keep per-sample rows."
        )

    _negative_index_dropped = False

    if ignore_index is not None and ignore_index < 0 and mode is not None:
        if reduce in ("micro", "macro") and mdmc_reduce != "samplewise":
            preds, target, sample_mask = _mask_negative_ignored_indices(preds, target, ignore_index, mode, sample_mask)
        else:
            preds, target = _drop_negative_ignored_indices(preds, target, ignore_index, mode)
        _negative_index_dropped = True

    # a negative ignore_index not consumed above (mode unknown) stays off the fast path
    _unhandled_negative_ignore = ignore_index is not None and ignore_index < 0 and not _negative_index_dropped
    if not _unhandled_negative_ignore and _fast_multiclass_eligible(preds, target, reduce, top_k, multiclass, num_classes):
        if mode is None:
            # the formatting path's checks, for the same errors
            checked_mode = _check_classification_inputs(
                preds,
                target,
                threshold=threshold,
                num_classes=num_classes,
                multiclass=multiclass,
                top_k=top_k,
                ignore_index=ignore_index,
            )
        else:
            checked_mode = mode
        if checked_mode == DataType.MULTICLASS:
            fast_ignore = ignore_index if not _negative_index_dropped else None
            if fast_ignore is not None and fast_ignore >= preds.shape[1]:
                raise ValueError(
                    f"The `ignore_index` {fast_ignore} is not valid for inputs with {preds.shape[1]} classes"
                )
            return _fast_multiclass_stat_scores(preds, target, reduce, fast_ignore, sample_mask)

    preds, target, _ = _input_format_classification(
        preds,
        target,
        threshold=threshold,
        num_classes=num_classes,
        multiclass=multiclass,
        top_k=top_k,
        ignore_index=ignore_index,
    )

    if ignore_index is not None and ignore_index >= preds.shape[1]:
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {preds.shape[1]} classes")
    if ignore_index is not None and preds.shape[1] == 1:
        raise ValueError("You can not use `ignore_index` with binary data.")

    if preds.ndim == 3:
        if not mdmc_reduce:
            raise ValueError(
                "When your inputs are multi-dimensional multi-class, you have to set the `mdmc_reduce` parameter"
            )
        if mdmc_reduce == "global":
            if sample_mask is not None:
                # one mask row per (batch, extra-dim) pair, in the order of the reshape below
                if sample_mask.ndim == 1 and sample_mask.shape[0] != preds.shape[0] * preds.shape[2]:
                    sample_mask = torch.repeat_interleave(sample_mask, preds.shape[2])
                else:
                    sample_mask = sample_mask.reshape(-1)
            preds = torch.transpose(preds, 1, 2).reshape(-1, preds.shape[1])
            target = torch.transpose(target, 1, 2).reshape(-1, target.shape[1])

    if ignore_index is not None and reduce != "macro" and not _negative_index_dropped:
        preds = _del_column(preds, ignore_index)
        target = _del_column(target, ignore_index)

    tp, fp, tn, fn = _stat_scores(preds, target, reduce=reduce, sample_mask=sample_mask)

    if ignore_index is not None and reduce == "macro" and not _negative_index_dropped:
        for t in (tp, fp, tn, fn):
            t[..., ignore_index] = -1

    return tp, fp, tn, fn


def _stat_scores_compute(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Tensor:
    """Stack [tp, fp, tn, fn, support] along the last axis."""
    outputs = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    return torch.where(outputs < 0, -1, outputs)


def _reduce_stat_scores(
    numerator: Tensor,
    denominator: Tensor,
    weights: Optional[Tensor],
    average: Optional[str],
    mdmc_average: Optional[str],
    zero_division: int = 0,
) -> Tensor:
    """Reduce per-class ``numerator/denominator`` scores. A negative
    denominator marks an ignored class; a zero one scores ``zero_division``."""
    numerator, denominator = numerator.float(), denominator.float()
    zero_div_mask = denominator == 0
    ignore_mask = denominator < 0

    weights = torch.ones_like(denominator) if weights is None else weights.float()

    numerator = torch.where(zero_div_mask, float(zero_division), numerator)
    denominator = torch.where(zero_div_mask | ignore_mask, 1.0, denominator)
    weights = torch.where(ignore_mask, 0.0, weights)

    if average not in (AverageMethod.MICRO, AverageMethod.NONE, None):
        weights = weights / weights.sum(dim=-1, keepdim=True)

    scores = weights * (numerator / denominator)
    scores = torch.where(torch.isnan(scores), float(zero_division), scores)

    if mdmc_average == MDMCAverageMethod.SAMPLEWISE and scores.ndim:
        scores = scores.mean(dim=0)
        ignore_mask = ignore_mask.sum(dim=0).bool()

    if average in (AverageMethod.NONE, None):
        scores = torch.where(ignore_mask, float("nan"), scores)
    else:
        scores = scores.sum()

    return scores


def stat_scores(
    preds: Tensor,
    target: Tensor,
    reduce: str = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    threshold: float = 0.5,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Number of TP/FP/TN/FN (and support) for classification inputs.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import stat_scores
        >>> scores = stat_scores(torch.tensor([1, 0, 2, 1]), torch.tensor([1, 1, 2, 0]), num_classes=3, reduce='micro')
        >>> [int(v) for v in scores]  # tp, fp, tn, fn, support
        [2, 2, 6, 2, 4]
    """
    if reduce not in ["micro", "macro", "samples"]:
        raise ValueError(f"The `reduce` {reduce} is not valid.")
    if mdmc_reduce not in [None, "samplewise", "global"]:
        raise ValueError(f"The `mdmc_reduce` {mdmc_reduce} is not valid.")
    if reduce == "macro" and (not num_classes or num_classes < 1):
        raise ValueError("When you set `reduce` as 'macro', you have to provide the number of classes.")
    if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")

    tp, fp, tn, fn = _stat_scores_update(
        preds,
        target,
        reduce=reduce,
        mdmc_reduce=mdmc_reduce,
        top_k=top_k,
        threshold=threshold,
        num_classes=num_classes,
        multiclass=multiclass,
        ignore_index=ignore_index,
    )
    return _stat_scores_compute(tp, fp, tn, fn)
