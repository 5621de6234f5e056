"""Fréchet Inception Distance: port of ``metrics_tpu/image/fid.py``.

The trace of the matrix square root has the JAX package's three algorithms
(``sqrtm_method``): ``"eigh"`` (two symmetric eigendecompositions),
``"eigh_host"`` (the same on the CPU, one copy each way) and
``"newton_schulz"`` (the coupled iteration, products only). ``None`` picks
``eigh`` for a CPU tensor and for an eager compute on the card (cuSOLVER:
the JAX package went to the host only because the TPU's eigensolver is
slow), and Newton–Schulz inside an engine's program (``_is_traced()``),
where the JAX package picks it under ``jit``. The metric's ``compute``
telemetry span carries the one it took (``sqrtm_method``).

Newton–Schulz runs a fixed 60 iterations in place of ``lax.while_loop``: a
carried ``done`` flag freezes the iterate at the first step whose residual
grows by more than ``growth`` or goes non-finite, as the loop's exit does,
so eager and captured computes give the same iterate with no host read a
step.

The compute runs in float64 on the states' device, eager or captured: the
means and covariances (the list path's from its features, the moment path's
``Σxxᵀ - n μμᵀ`` from its float32 sums, as the JAX package's eager compute
does that subtraction in host numpy float64) and the matrix square root;
the value comes back in float32. The JAX package computes the square root
in float32 with x64 off; a covariance with many small eigenvalues (the
features of a randomly initialised InceptionV3 on an H100 run gave
eigenvalues down to the float32 rounding of the largest) then loses a few
per cent of its traces to the rounding under the square roots, where
float64 keeps it. States and products elsewhere stay float32, TF32 off.

The moment sums are float32, as the JAX package's with x64 off. Features
whose mean is many times their spread (InceptionV3's pool features, ~10
times on an H100 run) cancel in ``Σxxᵀ - n μμᵀ``: over 10,000 images the
float32 sums put ~1e-4 of absolute error on FID, which a FID in single
digits feels. ``set_dtype(torch.float64)`` keeps them in float64, as
TorchMetrics' ``FrechetInceptionDistance`` does and the JAX package's under
x64: each update's ``f.T @ f`` is then exact products of the float32
features summed in float64.

In a program the engine captures, the moment sums of an update open the
device phase ``count`` (:mod:`metrics_tpu_torch.ops.marks`), after the
bundled extractor's ``extract``.
"""
from typing import Any, Callable, Optional, Tuple

import torch
from torch import Tensor, nn

from metrics_tpu_torch import telemetry
from metrics_tpu_torch.functional.image.helper import _full_float32
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops import marks
from metrics_tpu_torch.utilities.checks import _is_traced
from metrics_tpu_torch.utilities.data import dim_zero_cat

_SQRTM_METHODS = (None, "eigh", "eigh_host", "newton_schulz")


def _eigvalsh(mat: Tensor) -> Tuple[Tensor, Tensor]:
    """``jnp.linalg.eigh``: the input symmetrised first."""
    return torch.linalg.eigh((mat + mat.T) / 2)


def _sym_sqrtm(mat: Tensor, eps: float = 1e-12) -> Tensor:
    """Symmetric PSD matrix square root through an eigendecomposition."""
    vals, vecs = _eigvalsh(mat)
    vals = vals.clamp_min(0.0)
    return (vecs * torch.sqrt(vals + eps)) @ vecs.T


def _trace_sqrtm_eigh(sigma1: Tensor, sigma2: Tensor) -> Tensor:
    """tr(sqrtm(sigma1 @ sigma2)) from the symmetric ``sqrt(S1) S2 sqrt(S1)``."""
    with _full_float32():
        s1_half = _sym_sqrtm(sigma1)
        vals, _ = _eigvalsh(s1_half @ sigma2 @ s1_half)
    return torch.sqrt(vals.clamp_min(0.0)).sum()


def _trace_sqrtm_eigh_host(sigma1: Tensor, sigma2: Tensor) -> Tensor:
    """The eigh path on the CPU: one copy of each covariance there, the scalar back."""
    return _trace_sqrtm_eigh(sigma1.cpu(), sigma2.cpu()).to(sigma1.device)


def _newton_schulz(
    sigma1: Tensor, sigma2: Tensor, max_iters: int = 60, growth: float = 1.2
) -> Tuple[Tensor, Tensor, Tensor]:
    """The coupled Newton–Schulz iteration on ``A / ||A||_F`` for
    tr(sqrtm(sigma1 @ sigma2)), frozen at the first step whose residual
    ``||ZY - I||_F`` grows by more than ``growth`` or is not finite: the JAX
    package's early-stopped loop, run to ``max_iters`` steps with the freeze
    carried. Returns the trace, the steps the loop ran (its exit count: the
    step that froze it, or ``max_iters``) and whether it froze."""
    with _full_float32():
        a = sigma1 @ sigma2
        norm = torch.linalg.norm(a)
        norm = torch.where(norm > 0, norm, torch.ones_like(norm))
        eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
        y = a / norm
        z, zy = eye, y
        prev = torch.full((), float("inf"), dtype=a.dtype, device=a.device)
        done = torch.zeros((), dtype=torch.bool, device=a.device)
        steps = torch.zeros((), dtype=torch.int32, device=a.device)
        for _ in range(max_iters):
            steps = steps + (~done).to(torch.int32)
            t = 0.5 * (3.0 * eye - zy)
            y2, z2 = y @ t, t @ z
            zy2 = z2 @ y2
            res = torch.linalg.norm(zy2 - eye)
            done = done | ~torch.isfinite(res) | (res > growth * prev)
            y, z, zy = torch.where(done, y, y2), torch.where(done, z, z2), torch.where(done, zy, zy2)
            prev = torch.where(done, prev, res)
    return torch.sqrt(norm) * torch.trace(y), steps, done


def _trace_sqrtm_newton_schulz(sigma1: Tensor, sigma2: Tensor, max_iters: int = 60, growth: float = 1.2) -> Tensor:
    """tr(sqrtm(sigma1 @ sigma2)) by the early-stopped Newton–Schulz iteration (:func:`_newton_schulz`)."""
    return _newton_schulz(sigma1, sigma2, max_iters, growth)[0]


def _trace_sqrtm_product(sigma1: Tensor, sigma2: Tensor, method: Optional[str] = None) -> Tensor:
    """tr(sqrtm(sigma1 @ sigma2)) by ``method``; None picks ``eigh`` on the
    CPU and eagerly on the card, ``newton_schulz`` in an engine's program."""
    if method is None:
        method = "newton_schulz" if sigma1.device.type != "cpu" and _is_traced() else "eigh"
    telemetry.annotate(sqrtm_method=method)  # on the metric's ``compute`` span
    if method == "eigh":
        return _trace_sqrtm_eigh(sigma1, sigma2)
    if method == "eigh_host":
        if _is_traced():
            raise ValueError(
                "`sqrtm_method='eigh_host'` moves values to the host CPU backend and cannot"
                " run inside `jit`; use 'eigh' or 'newton_schulz' in jitted code"
            )
        return _trace_sqrtm_eigh_host(sigma1, sigma2)
    if method == "newton_schulz":
        return _trace_sqrtm_newton_schulz(sigma1, sigma2)
    raise ValueError(
        f"Expected `sqrtm_method` to be one of ['eigh', 'eigh_host', 'newton_schulz', None] but got {method}"
    )


def _compute_fid(mu1: Tensor, sigma1: Tensor, mu2: Tensor, sigma2: Tensor, sqrtm_method: Optional[str] = None) -> Tensor:
    """FID from the two means and covariances."""
    diff = mu1 - mu2
    a = (diff * diff).sum()
    b = torch.trace(sigma1) + torch.trace(sigma2)
    c = _trace_sqrtm_product(sigma1, sigma2, method=sqrtm_method)
    return a + b - 2 * c


def _mean_cov(features: Tensor) -> Tuple[Tensor, Tensor]:
    """The mean and unbiased covariance of ``(N, D)`` features, in float64."""
    x = features.to(torch.float64)
    mu = x.mean(dim=0)
    centered = x - mu
    return mu, centered.T @ centered / (x.shape[0] - 1)


def _moments_to_mean_cov(num: Tensor, feat_sum: Tensor, outer_sum: Tensor) -> Tuple[Tensor, Tensor]:
    """``(n, Σx, Σxxᵀ) -> (μ, unbiased Σ)`` in float64 (the JAX package's
    eager ``_moments_to_mean_cov_host64``: the same elementwise float64
    arithmetic, on the states' device)."""
    n = num.to(torch.float64)
    mu = feat_sum.to(torch.float64) / n
    sigma = (outer_sum.to(torch.float64) - n * torch.outer(mu, mu)) / (n - 1.0)
    return mu, sigma


class FrechetInceptionDistance(Metric):
    """FID between the accumulated real and generated feature distributions.

    Args:
        feature_extractor: a callable (an ``nn.Module`` moves with the
            metric) mapping an image batch to ``(N, D)`` features; None
            takes features as the update's input.
        reset_real_features: False keeps the real side across ``reset()``.
        sqrtm_method: ``"eigh"``, ``"eigh_host"``, ``"newton_schulz"`` or
            None (see the module's docstring).
        feature_dim: keep the running moments ``(n, Σx, Σxxᵀ)`` of each side
            (float32, or float64 after ``set_dtype(torch.float64)``; summed
            across processes) instead of feature lists.
        feature_shift: a constant (scalar or ``(feature_dim,)``) taken off
            the features before the moments and put back on the means.
        feature: the bundled InceptionV3 at a 64 / 192 / 768 / 2048 tap.
        weights_path: a flax ``.npz`` of its weights (implies ``feature=2048``).

    Example (pre-extracted features):
        >>> import torch
        >>> from metrics_tpu_torch import FrechetInceptionDistance
        >>> fid = FrechetInceptionDistance(device="cpu")
        >>> g = torch.Generator().manual_seed(0)
        >>> fid.update(torch.randn(64, 8, generator=g), real=True)
        >>> fid.update(torch.randn(64, 8, generator=g) + 1.0, real=False)
        >>> float(fid.compute()) > 0
        True
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        feature_extractor: Optional[Callable[[Tensor], Tensor]] = None,
        reset_real_features: bool = True,
        sqrtm_method: Optional[str] = None,
        feature_dim: Optional[int] = None,
        feature_shift: Optional[Any] = None,
        feature: Optional[Any] = None,
        weights_path: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if feature is not None or weights_path is not None:
            from metrics_tpu_torch.image.inception_net import resolve_ctor_extractor

            feature_extractor = resolve_ctor_extractor(
                feature_extractor, feature, weights_path, default_output=2048, allowed=(64, 192, 768, 2048)
            )
        if isinstance(feature_extractor, nn.Module):
            feature_extractor = feature_extractor.to(self.device)
        self.feature_extractor = feature_extractor
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        if sqrtm_method not in _SQRTM_METHODS:
            raise ValueError(
                f"Expected `sqrtm_method` to be one of ['eigh', 'eigh_host', 'newton_schulz', None]"
                f" but got {sqrtm_method}"
            )
        self.sqrtm_method = sqrtm_method
        if feature_dim is not None and not (isinstance(feature_dim, int) and feature_dim > 0):
            raise ValueError("Argument `feature_dim` expected to be `None` or a positive integer")
        self.feature_dim = feature_dim
        if feature_shift is not None:
            if feature_dim is None:
                raise ValueError(
                    "Argument `feature_shift` requires the moment-state path (`feature_dim=`);"
                    " the list path centers exactly and needs no shift"
                )
            shift = torch.as_tensor(feature_shift, dtype=torch.float32).to(self.device)
            if shift.ndim not in (0, 1) or (shift.ndim == 1 and shift.shape[0] != feature_dim):
                raise ValueError(
                    f"Argument `feature_shift` must be a scalar or shape ({feature_dim},),"
                    f" got shape {tuple(shift.shape)}"
                )
            feature_shift = shift
        self.feature_shift = feature_shift
        self._device_attributes = tuple(
            name for name in ("feature_extractor", "feature_shift")
            if isinstance(getattr(self, name), (nn.Module, torch.Tensor))
        )

        if feature_dim is None:
            self.add_state("real_features", [], dist_reduce_fx=None)
            self.add_state("fake_features", [], dist_reduce_fx=None)
        else:
            for prefix in ("real", "fake"):
                self.add_state(f"{prefix}_num_samples", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
                self.add_state(f"{prefix}_features_sum", torch.zeros(feature_dim), dist_reduce_fx="sum")
                self.add_state(f"{prefix}_outer_sum", torch.zeros(feature_dim, feature_dim), dist_reduce_fx="sum")

    def _extract(self, imgs: Tensor) -> Tensor:
        features = self.feature_extractor(imgs) if self.feature_extractor is not None else imgs
        if features.ndim != 2:
            raise ValueError(f"Expected extracted features to be 2d (N, D), got shape {tuple(features.shape)}")
        if self.feature_dim is not None and features.shape[1] != self.feature_dim:
            raise ValueError(
                f"Expected extracted features to have dim {self.feature_dim}, got shape {tuple(features.shape)}"
            )
        return features

    def update(self, imgs: Tensor, real: bool) -> None:
        """Extract the features (or take them as given) and accumulate them."""
        features = self._extract(imgs)
        if self.feature_dim is not None:
            marks.mark("count")  # a captured program's phase mark: the moment sums
            prefix = "real" if real else "fake"
            f = features.to(getattr(self, f"{prefix}_features_sum").dtype)
            if self.feature_shift is not None:
                f = f - self.feature_shift.to(f.dtype)
            setattr(self, f"{prefix}_num_samples", getattr(self, f"{prefix}_num_samples") + f.shape[0])
            setattr(self, f"{prefix}_features_sum", getattr(self, f"{prefix}_features_sum") + f.sum(dim=0))
            with _full_float32():
                setattr(self, f"{prefix}_outer_sum", getattr(self, f"{prefix}_outer_sum") + f.T @ f)
        elif real:
            self.real_features.append(features)
        else:
            self.fake_features.append(features)

    def compute(self) -> Tensor:
        """FID over the accumulated features."""
        if self.feature_dim is not None:
            if not _is_traced():
                for n in (self.real_num_samples, self.fake_num_samples):
                    if int(n) == 0:  # the list path's failure on an empty side
                        raise ValueError("No samples to concatenate")
            mu1, sigma1 = _moments_to_mean_cov(self.real_num_samples, self.real_features_sum, self.real_outer_sum)
            mu2, sigma2 = _moments_to_mean_cov(self.fake_num_samples, self.fake_features_sum, self.fake_outer_sum)
            if self.feature_shift is not None:  # covariances are shift-invariant; the means move back
                shift = self.feature_shift.to(torch.float64)
                mu1, mu2 = mu1 + shift, mu2 + shift
        else:
            mu1, sigma1 = _mean_cov(dim_zero_cat(self.real_features).to(torch.float32))
            mu2, sigma2 = _mean_cov(dim_zero_cat(self.fake_features).to(torch.float32))
        return _compute_fid(mu1, sigma1, mu2, sigma2, sqrtm_method=self.sqrtm_method).to(torch.float32)

    def reset(self) -> None:
        """Reset, keeping the real side with ``reset_real_features=False``."""
        if not self.reset_real_features:
            self._reset_preserving("real")
        else:
            super().reset()
