"""BERTScore with an injectable embedder: port of ``metrics_tpu/functional/text/bert.py``.

The matching is the JAX package's: the cosine between every pair of
contextual token embeddings, each token's best match, and their (optionally
IDF-weighted) means as precision, recall and F1. The embedder is any
callable ``List[str] -> (embeddings (N, L, D), mask (N, L), input_ids (N, L))``.
With none given, the bundled deterministic :class:`HashEmbedder` runs (a
lexical baseline that needs no weights); :func:`transformers_embedder`
wraps a local Hugging Face checkpoint through PyTorch.

The matcher is one batched product on ``device`` with TF32 off, as the JAX
package computes it in full float32. Both sides are padded to a common
power-of-two length, as in the JAX package: a padded position is masked,
so its similarity is 0 and takes part in the maxima, flooring a row whose
similarities are all negative at 0. IDF weights are made on the host from
the ids and masks, as the JAX package makes them.
"""
import copy
import hashlib
import math
import re
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.functional.image.helper import _full_float32
from metrics_tpu_torch.functional.text.helper import _to_device
from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.utilities.data import bucket_pow2
from metrics_tpu_torch.utilities.imports import _TRANSFORMERS_AVAILABLE
from metrics_tpu_torch.utilities.prints import rank_zero_warn

EmbedderType = Callable[[List[str]], Tuple[Tensor, Tensor, Tensor]]

# XLA's CPU cumsum: sequential float32 sums within blocks of this many elements, then the blocks' sums
_SCAN_BLOCK = 16


def _compute_idf(input_ids: np.ndarray, mask: np.ndarray) -> Dict[int, float]:
    """Corpus-level inverse document frequencies of the attended tokens."""
    num_docs = input_ids.shape[0]
    df: Counter = Counter()
    for row, m in zip(input_ids, mask.astype(bool)):
        df.update(set(row[m].tolist()))
    return {token: math.log((num_docs + 1) / (df_t + 1)) for token, df_t in df.items()}


def _idf_weights(input_ids: np.ndarray, mask: np.ndarray, idf_dict: Dict[int, float]) -> np.ndarray:
    """Each attended token's IDF as float32 (unseen tokens get ``log(N + 1)``), 0 elsewhere."""
    default = math.log((input_ids.shape[0] + 1) / 1)
    uniq, inverse = np.unique(input_ids, return_inverse=True)
    per_id = np.asarray([idf_dict.get(int(t), default) for t in uniq.tolist()], dtype=np.float64)
    out = per_id[inverse.reshape(input_ids.shape)].astype(np.float32)
    out[~mask.astype(bool)] = 0.0
    return out


def _greedy_cosine_match(
    pred_emb: Tensor,
    pred_mask: Tensor,
    tgt_emb: Tensor,
    tgt_mask: Tensor,
    pred_weights: Optional[Tensor] = None,
    tgt_weights: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Batched greedy max-cosine matching: (precision, recall, F1), each (N,) float32."""
    pred_emb = pred_emb / torch.linalg.vector_norm(pred_emb, dim=-1, keepdim=True).clamp(min=1e-12)
    tgt_emb = tgt_emb / torch.linalg.vector_norm(tgt_emb, dim=-1, keepdim=True).clamp(min=1e-12)
    with _full_float32():
        sim = torch.bmm(pred_emb, tgt_emb.transpose(1, 2))  # (N, Lp, Lt)
    # masked positions take part with similarity 0 (the reference multiplies its embeddings by the mask)
    sim = torch.where(pred_mask[:, :, None] > 0, sim, 0.0)
    sim = torch.where(tgt_mask[:, None, :] > 0, sim, 0.0)

    best_for_pred = sim.amax(dim=2)  # (N, Lp)
    best_for_tgt = sim.amax(dim=1)  # (N, Lt)

    pred_weights = pred_mask.to(torch.float32) if pred_weights is None else pred_weights * pred_mask
    tgt_weights = tgt_mask.to(torch.float32) if tgt_weights is None else tgt_weights * tgt_mask

    precision = (best_for_pred * pred_weights).sum(dim=1) / pred_weights.sum(dim=1).clamp(min=1e-12)
    recall = (best_for_tgt * tgt_weights).sum(dim=1) / tgt_weights.sum(dim=1).clamp(min=1e-12)
    f1 = 2 * precision * recall / (precision + recall).clamp(min=1e-12)
    return precision, recall, f1


class HashEmbedder:
    """Deterministic zero-config embedder: hashed token vectors and local context.

    Each token maps to a fixed pseudo-random unit vector drawn from a BLAKE2b
    digest of its text (the same across runs, processes and platforms),
    mixed with its neighbours' vectors so that matching depends on order.
    Identical corpora score 1 and disjoint ones near 0, reproducibly; the
    scores are NOT comparable to published BERTScore numbers (inject
    :func:`transformers_embedder` for those). Its outputs are the JAX
    package's bit for bit, and reach ``device`` (``cuda`` unless given) in one
    copy a call: float32 embeddings, int32 masks and int32 ids.

    Args:
        dim: embedding width.
        max_length: token truncation length.
        context_weight: neighbour-mixing weight (0 = bag-of-words).
        device: where the outputs go.
    """

    emits_special_tokens = False  # no [CLS]/[SEP]: positional exclusion must not run

    def __init__(
        self,
        dim: int = 128,
        max_length: int = 128,
        context_weight: float = 0.3,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        self.dim = dim
        self.max_length = max_length
        self.context_weight = context_weight
        self.device = device
        self._token_cache: Dict[str, Tuple[np.ndarray, int]] = {}

    def on(self, device: Optional[Union[str, torch.device]]) -> "HashEmbedder":
        """This embedder with its outputs sent to ``device``; the two share their token cache."""
        other = copy.copy(self)
        other.device = device
        return other

    def _token_entry(self, token: str) -> Tuple[np.ndarray, int]:
        """(unit vector, id) of a token: one BLAKE2b digest a distinct token."""
        entry = self._token_cache.get(token)
        if entry is None:
            digest = hashlib.blake2b(token.encode("utf-8"), digest_size=8).digest()
            seed = int.from_bytes(digest[:4], "little")
            rng = np.random.RandomState(seed)  # MT19937: stable across platforms
            vec = rng.standard_normal(self.dim).astype(np.float32)
            vec /= max(float(np.linalg.norm(vec)), 1e-12)
            token_id = 1 + int.from_bytes(digest[4:8], "little") % (2**30)  # 0 is the pad id
            entry = (vec, token_id)
            self._token_cache[token] = entry
        return entry

    @staticmethod
    def tokenize(sentence: str) -> List[str]:
        return re.findall(r"\w+|[^\w\s]", sentence.lower())

    def __call__(self, sentences: List[str]) -> Tuple[Tensor, Tensor, Tensor]:
        token_lists = [self.tokenize(s)[: self.max_length] for s in sentences]
        length = max(1, max((len(t) for t in token_lists), default=1))
        n = len(sentences)
        emb = np.zeros((n, length, self.dim), dtype=np.float32)
        mask = np.zeros((n, length), dtype=np.int32)
        ids = np.zeros((n, length), dtype=np.int32)
        for i, tokens in enumerate(token_lists):
            if not tokens:
                continue
            entries = [self._token_entry(t) for t in tokens]
            vecs = np.stack([v for v, _ in entries])
            mixed = vecs.copy()
            if self.context_weight and len(tokens) > 1:
                mixed[1:] += self.context_weight * vecs[:-1]
                mixed[:-1] += self.context_weight * vecs[1:]
            emb[i, : len(tokens)] = mixed
            mask[i, : len(tokens)] = 1
            ids[i, : len(tokens)] = [tid for _, tid in entries]
        # the three arrays are 4-byte words: one int32 buffer, one copy
        host = torch.from_numpy(np.concatenate([emb.view(np.int32).ravel(), mask.ravel(), ids.ravel()]))
        buf = _to_device(host, resolve_device(self.device))
        n_emb, n_mask = emb.size, mask.size
        return (
            buf[:n_emb].view(torch.float32).reshape(emb.shape),
            buf[n_emb:n_emb + n_mask].reshape(mask.shape),
            buf[n_emb + n_mask:].reshape(ids.shape),
        )


_DEFAULT_EMBEDDER: Optional[HashEmbedder] = None
_WARNED_DEFAULT_EMBEDDER = False


def _default_embedder(device: Optional[Union[str, torch.device]] = None) -> HashEmbedder:
    """The process-wide zero-config embedder (one token-vector cache), sending its outputs to ``device``."""
    global _DEFAULT_EMBEDDER, _WARNED_DEFAULT_EMBEDDER
    if _DEFAULT_EMBEDDER is None:
        _DEFAULT_EMBEDDER = HashEmbedder()
    if not _WARNED_DEFAULT_EMBEDDER:
        _WARNED_DEFAULT_EMBEDDER = True
        rank_zero_warn(
            "BERTScore is running with the bundled deterministic hash embedder (no"
            " model assets required). Scores are reproducible lexical-similarity"
            " values, NOT comparable to published BERTScore numbers — pass"
            " `embedder=transformers_embedder(path)` or `model_name_or_path=`"
            " for a real contextual model."
        )
    return _DEFAULT_EMBEDDER.on(device)


def transformers_embedder(
    model_name_or_path: str,
    max_length: int = 512,
    device: Optional[Union[str, torch.device]] = None,
) -> EmbedderType:
    """An embedder from a local Hugging Face checkpoint with PyTorch weights,
    run on ``device`` (``cuda`` unless given) through ``AutoModel``; the
    tokenizer is called as the JAX package's Flax embedder calls it."""
    if not _TRANSFORMERS_AVAILABLE:
        raise ModuleNotFoundError(
            "`transformers_embedder` requires that `transformers` is installed. Use `pip install transformers`."
        )
    from transformers import AutoModel, AutoTokenizer

    device = resolve_device(device)
    tokenizer = AutoTokenizer.from_pretrained(model_name_or_path)
    model = AutoModel.from_pretrained(model_name_or_path).to(device).eval()

    def _embed(sentences: List[str]) -> Tuple[Tensor, Tensor, Tensor]:
        enc = tokenizer(sentences, return_tensors="pt", padding=True, truncation=True, max_length=max_length)
        input_ids, attention_mask = enc["input_ids"].to(device), enc["attention_mask"].to(device)
        with torch.no_grad(), _full_float32():
            out = model(input_ids=input_ids, attention_mask=attention_mask)
        return out.last_hidden_state, attention_mask, input_ids

    return _embed


def _sequential_cumsum(x: Tensor) -> Tensor:
    """Running float32 sums along the last axis, one add at a time."""
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[..., 0])
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
        out[..., j] = acc
    return out


def _cumsum_f32(x: Tensor) -> Tensor:
    """Running float32 sums of (N, L) ``x`` along its last axis, rounded as
    XLA's CPU cumsum rounds them: sequential within blocks of
    :data:`_SCAN_BLOCK`, each block then offset by the running sum of the
    blocks before it (the same scan over the blocks' totals)."""
    n, length = x.shape
    if length <= _SCAN_BLOCK:
        return _sequential_cumsum(x)
    n_blocks = -(-length // _SCAN_BLOCK)
    padded = x.new_zeros((n, n_blocks * _SCAN_BLOCK))
    padded[:, :length] = x
    local = _sequential_cumsum(padded.reshape(n, n_blocks, _SCAN_BLOCK))
    inclusive = _cumsum_f32(local[:, :, -1])
    offsets = torch.cat([inclusive.new_zeros((n, 1)), inclusive[:, :-1]], dim=1)
    return (local + offsets[:, :, None]).reshape(n, -1)[:, :length]


def _exclude_special_tokens(mask: Tensor) -> Tensor:
    """Zero the [CLS] (first) and [SEP] (last attended) positions.

    BERTScore matches content tokens only. The rule is positional, for a
    CLS-first, right-padded layout. The [SEP] position is the JAX package's:
    the first maximum of the float32 running sum of ``mask - 0.1``, rounded
    as the JAX package's CPU run rounds it, so that a mask with interior
    zeros (whose exact sums can tie) gives its position too, and an all-zero
    row gives 0.
    """
    mask = mask.clone()
    if not mask.numel():
        return mask
    mask[:, 0] = 0
    sep_pos = _cumsum_f32(mask.to(torch.float32) - 0.1).argmax(dim=-1, keepdim=True)
    return mask.scatter_(1, sep_pos, 0)  # a number argument: no host copy, no sync


def _pad_to(emb: Tensor, mask: Tensor, weights: Optional[Tensor], length: int):
    pad = length - emb.shape[1]
    if pad == 0:
        return emb, mask, weights
    emb = torch.nn.functional.pad(emb, (0, 0, 0, pad))
    mask = torch.nn.functional.pad(mask, (0, pad))
    if weights is not None:
        weights = torch.nn.functional.pad(weights, (0, pad))
    return emb, mask, weights


def bert_score(
    preds: Union[str, List[str]],
    target: Union[str, List[str]],
    embedder: Optional[EmbedderType] = None,
    model_name_or_path: Optional[str] = None,
    idf: bool = False,
    rescale_with_baseline: bool = False,
    baseline: Optional[Dict[str, float]] = None,
    exclude_special_tokens: bool = True,
    device: Optional[Union[str, torch.device]] = None,
    **kwargs: Any,
) -> Dict[str, Tensor]:
    """BERTScore precision, recall and F1, each an (N,) float32 tensor on ``device``.

    ``exclude_special_tokens`` drops the [CLS]/[SEP] positions from the
    matching and the means; embedders with ``emits_special_tokens = False``
    (like the zero-config default) opt out of it. ``model_name_or_path``
    builds :func:`transformers_embedder` of that checkpoint.

    Example (zero-config: the bundled deterministic hash embedder):
        >>> from metrics_tpu_torch.functional.text.bert import bert_score
        >>> out = bert_score(["hello there", "general kenobi"],
        ...                  ["hello there", "general kenobi"], device="cpu")
        >>> [round(float(f), 2) for f in out["f1"]]
        [1.0, 1.0]
    """
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    if len(preds) != len(target):
        raise ValueError("Number of predicted and reference sentences must be the same!")

    device = resolve_device(device)
    if embedder is None:
        if model_name_or_path is not None:
            embedder = transformers_embedder(model_name_or_path, device=device)
        else:
            embedder = _default_embedder(device)

    pred_emb, pred_mask, pred_ids = (torch.as_tensor(x, device=device) for x in embedder(list(preds)))
    tgt_emb, tgt_mask, tgt_ids = (torch.as_tensor(x, device=device) for x in embedder(list(target)))
    # embedders that emit no [CLS]/[SEP] (the hash default) opt out of the positional exclusion
    if not getattr(embedder, "emits_special_tokens", True):
        exclude_special_tokens = False
    if exclude_special_tokens:
        pred_mask = _exclude_special_tokens(pred_mask)
        tgt_mask = _exclude_special_tokens(tgt_mask)

    pred_weights = tgt_weights = None
    if idf:
        host = [x.cpu().numpy() for x in (pred_ids, pred_mask, tgt_ids, tgt_mask)]
        idf_dict = _compute_idf(host[2], host[3])
        weights = np.concatenate([_idf_weights(host[0], host[1], idf_dict).ravel(),
                                  _idf_weights(host[2], host[3], idf_dict).ravel()])
        weights = _to_device(torch.from_numpy(weights), device)
        pred_weights = weights[:pred_ids.numel()].reshape(pred_ids.shape)
        tgt_weights = weights[pred_ids.numel():].reshape(tgt_ids.shape)

    bucket = bucket_pow2(max(pred_emb.shape[1], tgt_emb.shape[1]))
    pred_emb, pred_mask, pred_weights = _pad_to(pred_emb, pred_mask, pred_weights, bucket)
    tgt_emb, tgt_mask, tgt_weights = _pad_to(tgt_emb, tgt_mask, tgt_weights, bucket)

    precision, recall, f1 = _greedy_cosine_match(pred_emb, pred_mask, tgt_emb, tgt_mask, pred_weights, tgt_weights)

    if rescale_with_baseline:
        if baseline is None:
            raise ValueError("`rescale_with_baseline` requires a `baseline` dict with keys precision/recall/f1")
        precision = (precision - baseline["precision"]) / (1 - baseline["precision"])
        recall = (recall - baseline["recall"]) / (1 - baseline["recall"])
        f1 = (f1 - baseline["f1"]) / (1 - baseline["f1"])

    return {"precision": precision, "recall": recall, "f1": f1}
