"""Inception Score: port of ``metrics_tpu/image/inception.py``.

The list path shuffles with ``np.random.permutation`` on the host and cuts
``torch.chunk``-sized chunks (``ceil(N / splits)`` rows each, so fewer than
``splits`` chunks where ``N % splits`` is not 0), std with ``ddof=1``. The
streaming path (``num_classes=``) keeps per-split sums in float32, added by
a one-hot product (full float32) on every device: on the card
``index_add_`` adds with atomics in no fixed order, so a captured update
would not repeat the eager bits, where the product does. Samples go to
splits round-robin by arrival, or, with ``assignment_rng_key``, by
``fold_in(key, samples seen)`` and ``randint``: the JAX package's draws bit
for bit (:mod:`~metrics_tpu_torch.utilities.jax_random`), on the device.
"""
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch import Tensor, nn

from metrics_tpu_torch.functional.image.helper import _full_float32
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities import jax_random
from metrics_tpu_torch.utilities.data import dim_zero_cat


class InceptionScore(Metric):
    """IS = exp(E_x KL(p(y|x) || p(y))), mean and std over ``splits`` chunks.

    Args:
        logits_extractor: a callable (an ``nn.Module`` moves with the
            metric) mapping images to ``(N, K)`` logits; None takes logits
            as the update's input.
        splits: the number of chunks.
        num_classes: keep per-split running sums ``Σ p(y|x)``, ``Σ p log p``
            and counts instead of a logits list.
        assignment_rng_key: (streaming path) an int seed or raw uint32 key
            data: samples go to random splits.
        feature: the bundled InceptionV3 at ``'logits_unbiased'`` or a 64 /
            192 / 768 / 2048 tap.
        weights_path: a flax ``.npz`` of its weights (implies
            ``feature='logits_unbiased'``).

    Example (pre-extracted logits):
        >>> import torch
        >>> from metrics_tpu_torch import InceptionScore
        >>> inception = InceptionScore(splits=2, device="cpu")
        >>> inception.update(torch.randn(64, 10, generator=torch.Generator().manual_seed(0)))
        >>> mean, std = inception.compute()
        >>> float(mean) > 0
        True
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        logits_extractor: Optional[Callable[[Tensor], Tensor]] = None,
        splits: int = 10,
        num_classes: Optional[int] = None,
        assignment_rng_key: Optional[Any] = None,
        feature: Optional[Any] = None,
        weights_path: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if feature is not None or weights_path is not None:
            from metrics_tpu_torch.image.inception_net import resolve_ctor_extractor

            logits_extractor = resolve_ctor_extractor(
                logits_extractor, feature, weights_path, default_output="logits_unbiased",
                allowed=("logits_unbiased", 64, 192, 768, 2048),
            )
        if isinstance(logits_extractor, nn.Module):
            logits_extractor = logits_extractor.to(self.device)
        self.logits_extractor = logits_extractor
        if not (isinstance(splits, int) and splits > 0):
            raise ValueError("Integer input to argument `splits` expected to be positive")
        self.splits = splits
        if num_classes is not None and not (isinstance(num_classes, int) and num_classes > 0):
            raise ValueError("Argument `num_classes` expected to be `None` or a positive integer")
        self.num_classes = num_classes
        if assignment_rng_key is not None:
            if num_classes is None:
                raise ValueError(
                    "Argument `assignment_rng_key` applies to the streaming path only"
                    " (`num_classes=`); the list path already shuffles at compute"
                )
            from metrics_tpu_torch.utilities.checks import as_rng_key

            assignment_rng_key = as_rng_key(assignment_rng_key, "assignment_rng_key").to(self.device)
        self.assignment_rng_key = assignment_rng_key
        self._device_attributes = tuple(
            name for name in ("logits_extractor", "assignment_rng_key")
            if isinstance(getattr(self, name), (nn.Module, Tensor))
        )
        if num_classes is None:
            self.add_state("features", [], dist_reduce_fx=None)
        else:
            self.add_state("prob_sum", torch.zeros(splits, num_classes), dist_reduce_fx="sum")
            self.add_state("plogp_sum", torch.zeros(splits), dist_reduce_fx="sum")
            self.add_state("split_count", torch.zeros(splits), dist_reduce_fx="sum")
            self.add_state("num_seen", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, imgs: Tensor) -> None:
        features = self.logits_extractor(imgs) if self.logits_extractor is not None else imgs
        if self.num_classes is None:
            self.features.append(features)
            return
        if features.ndim != 2 or features.shape[1] != self.num_classes:
            raise ValueError(f"Expected logits of shape (N, {self.num_classes}), got {tuple(features.shape)}")
        n = features.shape[0]
        prob = torch.softmax(features, dim=1)
        log_prob = torch.log_softmax(features, dim=1)
        if self.assignment_rng_key is not None:
            key = jax_random.fold_in(self.assignment_rng_key, self.num_seen)
            ids = jax_random.randint(key, (n,), 0, self.splits).long()
        else:
            ids = (self.num_seen + torch.arange(n, device=features.device)) % self.splits

        member = ids[None, :] == torch.arange(self.splits, device=ids.device)[:, None]

        def segment_sum(values: Tensor) -> Tensor:
            with _full_float32():
                return member.to(values.dtype) @ values

        self.prob_sum = self.prob_sum + segment_sum(prob)
        self.plogp_sum = self.plogp_sum + segment_sum((prob * log_prob).sum(dim=1))
        self.split_count = self.split_count + segment_sum(torch.ones(n, device=features.device))
        self.num_seen = self.num_seen + n

    def compute(self) -> Tuple[Tensor, Tensor]:
        """Mean and std (``ddof=1``) of the per-split scores."""
        if self.num_classes is not None:
            mean_prob = self.prob_sum / self.split_count[:, None]
            marginal_entropy = -(mean_prob * torch.log(mean_prob)).sum(dim=1)
            kl_arr = torch.exp(self.plogp_sum / self.split_count + marginal_entropy)
            return kl_arr.mean(), kl_arr.std()
        features = dim_zero_cat(self.features)
        idx = np.random.permutation(features.shape[0])  # the shuffle before chunking
        features = features[torch.from_numpy(idx).to(features.device)]
        prob = torch.softmax(features, dim=1)
        log_prob = torch.log_softmax(features, dim=1)
        # torch.chunk's sizes: ceil(N / splits) rows a chunk (at least 1, so no samples make one empty chunk)
        chunk_rows = max(-(-prob.shape[0] // self.splits), 1)
        boundaries = list(range(chunk_rows, prob.shape[0], chunk_rows))
        kl_scores = []
        for p, log_p in zip(torch.tensor_split(prob, boundaries), torch.tensor_split(log_prob, boundaries)):
            mean_prob = p.mean(dim=0, keepdim=True)
            kl_ = p * (log_p - torch.log(mean_prob))
            kl_scores.append(torch.exp(kl_.sum(dim=1).mean()))
        kl_arr = torch.stack(kl_scores)
        return kl_arr.mean(), kl_arr.std()
