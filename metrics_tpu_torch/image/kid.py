"""Kernel Inception Distance: port of ``metrics_tpu/image/kid.py``.

The list path draws its subsets with ``np.random.permutation`` on the host,
real and fake interleaved subset by subset as the JAX package draws them, so
one numpy seed gives the same subsets in both packages. The buffer path
(``feature_dim=`` with ``max_samples=``) writes each batch contiguously at
the fill count with device indices; eagerly an overflow raises, inside an
engine's program (where it cannot) it poisons the buffer with NaN, and a
merge compacts the two streams in order. With ``compute_rng_key`` the
compute draws its subsets from :mod:`~metrics_tpu_torch.utilities.jax_random`
(uniform priorities, the ``subset_size`` largest kept, lower index first on
a tie as ``lax.top_k`` keeps them: a stable descending sort), the JAX
package's draws bit for bit.
"""
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import Tensor, nn

from metrics_tpu_torch.functional.image.helper import _full_float32
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities import jax_random
from metrics_tpu_torch.utilities.checks import _is_traced
from metrics_tpu_torch.utilities.data import dim_zero_cat


def maximum_mean_discrepancy(k_xx: Tensor, k_xy: Tensor, k_yy: Tensor) -> Tensor:
    """The unbiased MMD estimate from the three kernel matrices."""
    m = k_xx.shape[0]
    kt_xx_sum = (k_xx.sum(dim=-1) - torch.diagonal(k_xx)).sum()
    kt_yy_sum = (k_yy.sum(dim=-1) - torch.diagonal(k_yy)).sum()
    k_xy_sum = k_xy.sum()
    value = (kt_xx_sum + kt_yy_sum) / (m * (m - 1))
    return value - 2 * k_xy_sum / (m**2)


def poly_kernel(f1: Tensor, f2: Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0) -> Tensor:
    """The polynomial kernel matrix ``(f1 f2ᵀ gamma + coef) ** degree``."""
    if gamma is None:
        gamma = 1.0 / f1.shape[1]
    with _full_float32():
        return (f1 @ f2.T * gamma + coef) ** degree


def poly_mmd(
    f_real: Tensor, f_fake: Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0
) -> Tensor:
    """The polynomial-kernel MMD of two feature sets."""
    k_11 = poly_kernel(f_real, f_real, degree, gamma, coef)
    k_22 = poly_kernel(f_fake, f_fake, degree, gamma, coef)
    k_12 = poly_kernel(f_real, f_fake, degree, gamma, coef)
    return maximum_mean_discrepancy(k_11, k_12, k_22)


def _subset_indices(key: Tensor, mask: Tensor, k: int) -> Tensor:
    """``k`` rows drawn without replacement from the rows ``mask`` marks:
    the ``k`` largest uniform priorities of ``key`` (``-inf`` off the mask),
    the lower index first on a tie, as ``lax.top_k`` orders them."""
    priorities = torch.where(mask, jax_random.uniform(key, mask.shape), float("-inf"))
    return torch.sort(priorities, descending=True, stable=True).indices[:k]


def _poisoned(x: Tensor, flag: Tensor) -> Tensor:
    """``x`` plus NaN where the 0-d ``flag`` is set, plus 0 elsewhere."""
    return x + torch.where(flag, float("nan"), 0.0).to(x.dtype)


class KernelInceptionDistance(Metric):
    """KID: the polynomial MMD over random feature subsets.

    Args:
        feature_extractor: a callable (an ``nn.Module`` moves with the
            metric) mapping images to ``(N, D)`` features; None takes
            features as the update's input.
        subsets, subset_size, degree, gamma, coef: the estimator's.
        reset_real_features: False keeps the real side across ``reset()``.
        feature_dim, max_samples: together, a ``(max_samples, feature_dim)``
            float32 buffer and an int32 fill count a side in place of lists.
        compute_rng_key: (buffer path) an int seed or raw uint32 key data:
            the subsets drawn on the device from ``jax.random``'s stream.
        feature: the bundled InceptionV3 at a 64 / 192 / 768 / 2048 tap or
            ``'logits_unbiased'``.
        weights_path: a flax ``.npz`` of its weights (implies ``feature=2048``).

    Example (pre-extracted features):
        >>> import torch
        >>> from metrics_tpu_torch import KernelInceptionDistance
        >>> kid = KernelInceptionDistance(subsets=3, subset_size=32, device="cpu")
        >>> g = torch.Generator().manual_seed(0)
        >>> kid.update(torch.randn(64, 8, generator=g), real=True)
        >>> kid.update(torch.randn(64, 8, generator=g) + 1.0, real=False)
        >>> mean, std = kid.compute()
        >>> float(mean) > 0
        True
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        feature_extractor: Optional[Callable[[Tensor], Tensor]] = None,
        subsets: int = 100,
        subset_size: int = 1000,
        degree: int = 3,
        gamma: Optional[float] = None,
        coef: float = 1.0,
        reset_real_features: bool = True,
        feature_dim: Optional[int] = None,
        max_samples: Optional[int] = None,
        compute_rng_key: Optional[Any] = None,
        feature: Optional[Any] = None,
        weights_path: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if feature is not None or weights_path is not None:
            from metrics_tpu_torch.image.inception_net import resolve_ctor_extractor

            feature_extractor = resolve_ctor_extractor(
                feature_extractor, feature, weights_path, default_output=2048,
                allowed=("logits_unbiased", 64, 192, 768, 2048),
            )
        if isinstance(feature_extractor, nn.Module):
            feature_extractor = feature_extractor.to(self.device)
        self.feature_extractor = feature_extractor

        if not (isinstance(subsets, int) and subsets > 0):
            raise ValueError("Argument `subsets` expected to be integer larger than 0")
        self.subsets = subsets
        if not (isinstance(subset_size, int) and subset_size > 0):
            raise ValueError("Argument `subset_size` expected to be integer larger than 0")
        self.subset_size = subset_size
        if not (isinstance(degree, int) and degree > 0):
            raise ValueError("Argument `degree` expected to be integer larger than 0")
        self.degree = degree
        if gamma is not None and not (isinstance(gamma, float) and gamma > 0):
            raise ValueError("Argument `gamma` expected to be `None` or float larger than 0")
        self.gamma = gamma
        if not (isinstance(coef, float) and coef > 0):
            raise ValueError("Argument `coef` expected to be float larger than 0")
        self.coef = coef
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        if (feature_dim is None) != (max_samples is None):
            raise ValueError("Arguments `feature_dim` and `max_samples` must be given together")
        if feature_dim is not None and not (isinstance(feature_dim, int) and feature_dim > 0):
            raise ValueError("Argument `feature_dim` expected to be `None` or a positive integer")
        if max_samples is not None and not (isinstance(max_samples, int) and max_samples > 0):
            raise ValueError("Argument `max_samples` expected to be `None` or a positive integer")
        self.feature_dim = feature_dim
        self.max_samples = max_samples
        if compute_rng_key is not None:
            if feature_dim is None:
                raise ValueError(
                    "Argument `compute_rng_key` requires the fixed-shape buffer path"
                    " (`feature_dim=`/`max_samples=`): the list path has no static"
                    " bound to sample under jit"
                )
            from metrics_tpu_torch.utilities.checks import as_rng_key

            compute_rng_key = as_rng_key(compute_rng_key, "compute_rng_key").to(self.device)
            if subset_size > max_samples:
                raise ValueError(
                    f"Argument `subset_size` ({subset_size}) cannot exceed `max_samples`"
                    f" ({max_samples}) when `compute_rng_key` is set (the in-graph draw"
                    " samples from the fixed buffer)"
                )
        self.compute_rng_key = compute_rng_key
        self._device_attributes = tuple(
            name for name in ("feature_extractor", "compute_rng_key")
            if isinstance(getattr(self, name), (nn.Module, Tensor))
        )

        if feature_dim is None:
            self.add_state("real_features", [], dist_reduce_fx=None)
            self.add_state("fake_features", [], dist_reduce_fx=None)
        else:
            for prefix in ("real", "fake"):
                self.add_state(f"{prefix}_buffer", torch.zeros(max_samples, feature_dim), dist_reduce_fx=None)
                self.add_state(f"{prefix}_count", torch.zeros((), dtype=torch.int32), dist_reduce_fx=None)
            # raw sample rows: never narrowed by sync_dtype
            self._sample_state_names = {"real_buffer", "fake_buffer"}

    def update(self, imgs: Tensor, real: bool) -> None:
        features = self.feature_extractor(imgs) if self.feature_extractor is not None else imgs
        if self.feature_dim is None:
            (self.real_features if real else self.fake_features).append(features)
            return
        if features.ndim != 2 or features.shape[1] != self.feature_dim:
            raise ValueError(f"Expected extracted features of shape (N, {self.feature_dim}), got {tuple(features.shape)}")
        prefix = "real" if real else "fake"
        buf, count = getattr(self, f"{prefix}_buffer"), getattr(self, f"{prefix}_count")
        n = features.shape[0]
        if not _is_traced() and int(count) + n > self.max_samples:
            raise ValueError(
                f"KID buffer overflow: {int(count)} + {n} samples exceed `max_samples={self.max_samples}`"
            )
        # lax.dynamic_update_slice: the start clamped so that the batch fits
        start = torch.clamp(count.to(torch.int64), 0, max(self.max_samples - n, 0))
        buf = buf.index_copy(0, start + torch.arange(n, device=buf.device), features.to(buf.dtype))
        if _is_traced():  # the raise above cannot run in a program: an overflow poisons the buffer instead
            buf = _poisoned(buf, count + n > self.max_samples)
        setattr(self, f"{prefix}_buffer", buf)
        setattr(self, f"{prefix}_count", count + n)

    def _reduce_states(self, incoming_state: Dict[str, Any]) -> None:
        """Merge a buffer-mode state by compaction: the local rows shifted
        past the incoming count, masked (never wrapped) at the capacity; a
        merged total past ``max_samples`` raises eagerly and poisons the
        buffer with NaN in a program."""
        if self.feature_dim is None:
            return super()._reduce_states(incoming_state)
        cap = self.max_samples
        for prefix in ("real", "fake"):
            g_buf, g_cnt = incoming_state[f"{prefix}_buffer"], incoming_state[f"{prefix}_count"]
            l_buf, l_cnt = getattr(self, f"{prefix}_buffer"), getattr(self, f"{prefix}_count")
            if not _is_traced() and int(g_cnt) + int(l_cnt) > cap:
                raise ValueError(
                    f"KID buffer overflow on merge: {int(g_cnt)} + {int(l_cnt)} samples exceed `max_samples={cap}`"
                )
            idx = torch.arange(cap, device=l_buf.device) - g_cnt
            valid = (idx >= 0) & (idx < l_cnt)
            shifted = torch.where(valid[:, None], l_buf[idx.clamp(0, cap - 1)], torch.zeros((), dtype=l_buf.dtype,
                                                                                        device=l_buf.device))
            merged = _poisoned(g_buf + shifted, (g_cnt + l_cnt) > cap)
            object.__setattr__(self, f"{prefix}_buffer", merged)
            object.__setattr__(self, f"{prefix}_count", g_cnt + l_cnt)

    def _buffered(self, prefix: str) -> Tensor:
        """The valid rows of a buffer; a synced stack ``(world, capacity, D)`` flattened."""
        buf, count = getattr(self, f"{prefix}_buffer"), getattr(self, f"{prefix}_count")
        if buf.ndim == 3:
            return torch.cat([buf[i, : int(count[i])] for i in range(buf.shape[0])])
        return buf[: int(count)]

    def _compute_in_graph(self) -> Tuple[Tensor, Tensor]:
        """The buffer-mode compute with device draws: each subset takes the
        ``subset_size`` valid rows of highest uniform priority; an
        under-filled side poisons both outputs with NaN."""

        def _flat(prefix: str) -> Tuple[Tensor, Tensor, Tensor]:
            buf, count = getattr(self, f"{prefix}_buffer"), getattr(self, f"{prefix}_count")
            if buf.ndim == 3:
                mask = (torch.arange(buf.shape[1], device=buf.device)[None, :] < count[:, None]).reshape(-1)
                return buf.reshape(-1, buf.shape[-1]), mask, count.sum()
            return buf, torch.arange(buf.shape[0], device=buf.device) < count, count

        rbuf, rmask, rcnt = _flat("real")
        fbuf, fmask, fcnt = _flat("fake")

        k = self.subset_size
        scores = []
        for key in jax_random.split(self.compute_rng_key, self.subsets):
            key_r, key_f = jax_random.split(key)
            scores.append(poly_mmd(rbuf[_subset_indices(key_r, rmask, k)], fbuf[_subset_indices(key_f, fmask, k)],
                                   self.degree, self.gamma, self.coef))
        scores = torch.stack(scores)
        underfilled = (rcnt < self.subset_size) | (fcnt < self.subset_size)
        return _poisoned(scores.mean(), underfilled), _poisoned(scores.std(unbiased=False), underfilled)

    def compute(self) -> Tuple[Tensor, Tensor]:
        """Mean and (biased) std of the subsets' MMDs."""
        if self.feature_dim is not None:
            traced = _is_traced()
            if self.compute_rng_key is not None:
                if not traced:
                    for prefix in ("real", "fake"):
                        if int(getattr(self, f"{prefix}_count").sum()) < self.subset_size:
                            raise ValueError("Argument `subset_size` should be smaller than the number of samples")
                return self._compute_in_graph()
            if traced:
                raise ValueError(
                    "KernelInceptionDistance buffer-mode `compute()` under jit needs"
                    " `compute_rng_key=` (in-graph jax.random subset sampling); the"
                    " default path keeps the reference's host np.random stream,"
                    " which cannot trace"
                )
            real_features, fake_features = self._buffered("real"), self._buffered("fake")
        else:
            real_features, fake_features = dim_zero_cat(self.real_features), dim_zero_cat(self.fake_features)

        n_samples_real = real_features.shape[0]
        if n_samples_real < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")
        n_samples_fake = fake_features.shape[0]
        if n_samples_fake < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")

        # one permutation a side a subset, real and fake interleaved: the JAX package's host stream
        draws = [
            (np.random.permutation(n_samples_real)[: self.subset_size],
             np.random.permutation(n_samples_fake)[: self.subset_size])
            for _ in range(self.subsets)
        ]
        idx_real = torch.from_numpy(np.stack([d[0] for d in draws])).to(real_features.device)
        idx_fake = torch.from_numpy(np.stack([d[1] for d in draws])).to(fake_features.device)
        kid_scores = torch.stack([
            poly_mmd(real_features[ir], fake_features[if_], self.degree, self.gamma, self.coef)
            for ir, if_ in zip(idx_real, idx_fake)
        ])
        return kid_scores.mean(), kid_scores.std(unbiased=False)

    def reset(self) -> None:
        """Reset, keeping the real side with ``reset_real_features=False``."""
        if not self.reset_real_features:
            self._reset_preserving("real")
        else:
            super().reset()
