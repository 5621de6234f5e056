"""Audit-case registry: every exported metric, classified and exemplified.

Port of ``metrics_tpu/analysis/registry.py:33-368``. The program audit
(:mod:`~metrics_tpu_torch.analysis.program_audit`) needs three things a
metric's class alone does not give: a *construction* (some classes take
required arguments), *example update inputs* (tracing on fake tensors still
needs shapes and dtypes) and a *scope* that says which rules apply:

* ``device``: a fixed-shape or list-state metric whose pure paths must
  trace; the full rule set.
* ``host_only``: declared ``Metric.host_only`` (text, detection, PESQ): the
  update runs on the host by design, so the program rules are out of scope
  (the source lint still applies).
* ``extractor``: the net-backed image metrics (FID, IS, KID, LPIPS): on the
  device, but construction builds a convolutional net; not traced.
* ``wrapper``: metrics that own inner metrics (``BootStrapper`` and the
  like): their state does not close over the inner metrics' states, so
  ``pure_update`` is no self-contained reducer; state facts only.
* ``abstract``: bases that cannot be constructed.

The cases, the inputs and their shapes are the JAX registry's: the same
seeded numpy pools (``RandomState(41)``), with the JAX package's 32-bit
dtypes, so that both audits trace the same programs. A build takes the
device: ``"cpu"`` for the audit, ``"cuda"`` for the check on the card
(``chip_smoke.py``). JX000 is a registry gap: a name of the port's
``__all__`` that is a ``Metric`` subclass with no case here, or a kernel of
:mod:`metrics_tpu_torch.ops.registry` with no kernel case.
"""
import inspect
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch


class AuditCase(NamedTuple):
    name: str
    scope: str  # device | host_only | extractor | wrapper | abstract | kernel | unclassified
    build: Optional[Callable[..., Any]]  # build(device); None where the scope forbids or skips construction
    args: Optional[Callable[[Dict[str, torch.Tensor]], Tuple]]  # example update inputs from a pool
    note: str = ""


_ABSTRACT = {"Metric", "RetrievalMetric", "CompositionalMetric"}
_EXTRACTOR = {
    "FrechetInceptionDistance",
    "InceptionScore",
    "KernelInceptionDistance",
    "LearnedPerceptualImagePatchSimilarity",
}

_B, _C = 16, 4


def _pools() -> Dict[str, np.ndarray]:
    """The JAX registry's example-input pools (tiny shapes), as numpy in the
    dtypes ``jnp.asarray`` gives them with x64 off."""
    rng = np.random.RandomState(41)
    probs = rng.rand(_B, _C).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    pools = {
        "probs": probs,
        "labels": rng.randint(0, _C, _B),
        "bin_scores": rng.rand(_B).astype(np.float32),
        "bin_labels": rng.randint(0, 2, _B),
        "ml_scores": rng.rand(_B, _C).astype(np.float32),
        "ml_labels": rng.randint(0, 2, (_B, _C)),
        "reg_p": rng.rand(_B).astype(np.float32),
        "reg_t": rng.rand(_B).astype(np.float32),
        "reg2d_p": rng.rand(_B, 3).astype(np.float32),
        "reg2d_t": rng.rand(_B, 3).astype(np.float32),
        "audio_p": rng.randn(2, 200).astype(np.float32),
        "audio_t": rng.randn(2, 200).astype(np.float32),
        "stoi_t": rng.randn(1, 12000).astype(np.float32),
        "pit_p": rng.randn(2, 2, 100).astype(np.float32),
        "pit_t": rng.randn(2, 2, 100).astype(np.float32),
        "img_p": rng.rand(2, 3, 16, 16).astype(np.float32),
        "img_t": rng.rand(2, 3, 16, 16).astype(np.float32),
        "imgL_p": rng.rand(1, 3, 180, 180).astype(np.float32),
        "imgL_t": rng.rand(1, 3, 180, 180).astype(np.float32),
        "ret_idx": rng.randint(0, 4, _B),
    }
    pools["stoi_p"] = (pools["stoi_t"] + 0.8 * rng.randn(1, 12000)).astype(np.float32)
    return {k: v.astype(np.int32) if v.dtype == np.int64 else v for k, v in pools.items()}


def example_inputs(device: Any = "cpu") -> Dict[str, torch.Tensor]:
    """One pool of example input tensors on ``device``, shared by a sweep."""
    return {k: torch.from_numpy(v).to(device) for k, v in _pools().items()}


def _device_table() -> Dict[str, Tuple[Callable[..., Any], Callable[[Dict], Tuple]]]:
    """``name -> (build(device), args(pool))`` per device-scope metric."""
    import metrics_tpu_torch as M
    import metrics_tpu_torch.functional as F

    def case(ctor: Callable[..., Any], *keys: str) -> Tuple[Callable[..., Any], Callable[[Dict], Tuple]]:
        return ctor, (lambda pools: tuple(pools[k] for k in keys))

    def acc(d: Any) -> Any:
        return M.Accuracy(num_classes=_C, average="macro", device=d)

    t: Dict[str, Tuple[Callable[..., Any], Callable[[Dict], Tuple]]] = {
        # classification: fixed shape
        "Accuracy": case(acc, "probs", "labels"),
        "Precision": case(lambda d: M.Precision(num_classes=_C, average="macro", device=d), "probs", "labels"),
        "Recall": case(lambda d: M.Recall(num_classes=_C, average="macro", device=d), "probs", "labels"),
        "Specificity": case(lambda d: M.Specificity(num_classes=_C, average="macro", device=d), "probs", "labels"),
        "F1Score": case(lambda d: M.F1Score(num_classes=_C, average="macro", device=d), "probs", "labels"),
        "FBetaScore": case(lambda d: M.FBetaScore(num_classes=_C, beta=2.0, average="macro", device=d),
                           "probs", "labels"),
        "StatScores": case(lambda d: M.StatScores(num_classes=_C, reduce="macro", device=d), "probs", "labels"),
        "HammingDistance": case(lambda d: M.HammingDistance(device=d), "ml_scores", "ml_labels"),
        "ConfusionMatrix": case(lambda d: M.ConfusionMatrix(num_classes=_C, device=d), "probs", "labels"),
        "CohenKappa": case(lambda d: M.CohenKappa(num_classes=_C, device=d), "probs", "labels"),
        "MatthewsCorrCoef": case(lambda d: M.MatthewsCorrCoef(num_classes=_C, device=d), "probs", "labels"),
        "JaccardIndex": case(lambda d: M.JaccardIndex(num_classes=_C, device=d), "probs", "labels"),
        "BinnedPrecisionRecallCurve": case(
            lambda d: M.BinnedPrecisionRecallCurve(num_classes=_C, thresholds=8, device=d), "probs", "ml_labels"),
        "BinnedAveragePrecision": case(
            lambda d: M.BinnedAveragePrecision(num_classes=_C, thresholds=8, device=d), "probs", "ml_labels"),
        "BinnedRecallAtFixedPrecision": case(
            lambda d: M.BinnedRecallAtFixedPrecision(num_classes=_C, min_precision=0.5, thresholds=8, device=d),
            "probs", "ml_labels"),
        "KLDivergence": case(lambda d: M.KLDivergence(device=d), "probs", "probs"),
        "HingeLoss": case(lambda d: M.HingeLoss(device=d), "bin_scores", "bin_labels"),
        "CoverageError": case(lambda d: M.CoverageError(device=d), "ml_scores", "ml_labels"),
        "LabelRankingAveragePrecision": case(lambda d: M.LabelRankingAveragePrecision(device=d),
                                             "ml_scores", "ml_labels"),
        "LabelRankingLoss": case(lambda d: M.LabelRankingLoss(device=d), "ml_scores", "ml_labels"),
        # classification: list states (the curves; on the device, outside the engines)
        "AUC": case(lambda d: M.AUC(device=d), "reg_p", "reg_t"),
        "AUROC": case(lambda d: M.AUROC(device=d), "bin_scores", "bin_labels"),
        "AveragePrecision": case(lambda d: M.AveragePrecision(device=d), "bin_scores", "bin_labels"),
        "PrecisionRecallCurve": case(lambda d: M.PrecisionRecallCurve(device=d), "bin_scores", "bin_labels"),
        "ROC": case(lambda d: M.ROC(device=d), "bin_scores", "bin_labels"),
        "CalibrationError": case(lambda d: M.CalibrationError(device=d), "bin_scores", "bin_labels"),
        # regression
        "MeanSquaredError": case(lambda d: M.MeanSquaredError(device=d), "reg_p", "reg_t"),
        "MeanAbsoluteError": case(lambda d: M.MeanAbsoluteError(device=d), "reg_p", "reg_t"),
        "MeanSquaredLogError": case(lambda d: M.MeanSquaredLogError(device=d), "reg_p", "reg_t"),
        "MeanAbsolutePercentageError": case(lambda d: M.MeanAbsolutePercentageError(device=d), "reg_p", "reg_t"),
        "SymmetricMeanAbsolutePercentageError": case(
            lambda d: M.SymmetricMeanAbsolutePercentageError(device=d), "reg_p", "reg_t"),
        "WeightedMeanAbsolutePercentageError": case(
            lambda d: M.WeightedMeanAbsolutePercentageError(device=d), "reg_p", "reg_t"),
        "ExplainedVariance": case(lambda d: M.ExplainedVariance(device=d), "reg_p", "reg_t"),
        "R2Score": case(lambda d: M.R2Score(device=d), "reg_p", "reg_t"),
        "TweedieDevianceScore": case(lambda d: M.TweedieDevianceScore(power=1.5, device=d), "reg_p", "reg_t"),
        "PearsonCorrCoef": case(lambda d: M.PearsonCorrCoef(device=d), "reg_p", "reg_t"),
        "CosineSimilarity": case(lambda d: M.CosineSimilarity(device=d), "reg2d_p", "reg2d_t"),
        "SpearmanCorrCoef": case(lambda d: M.SpearmanCorrCoef(device=d), "reg_p", "reg_t"),
        # aggregation
        "MaxMetric": case(lambda d: M.MaxMetric(device=d), "reg_p"),
        "MinMetric": case(lambda d: M.MinMetric(device=d), "reg_p"),
        "SumMetric": case(lambda d: M.SumMetric(device=d), "reg_p"),
        "MeanMetric": case(lambda d: M.MeanMetric(device=d), "reg_p"),
        "CatMetric": case(lambda d: M.CatMetric(device=d), "reg_p"),
        # streaming: fixed-shape windows and sketches
        "SlidingWindow": case(lambda d: M.SlidingWindow(acc(d), window=4, slide=2), "probs", "labels"),
        "TumblingWindow": case(lambda d: M.TumblingWindow(acc(d), window=4), "probs", "labels"),
        "FoldTreeWindow": case(lambda d: M.FoldTreeWindow(acc(d), window=4, slide=2), "probs", "labels"),
        "ResolutionLadder": case(lambda d: M.ResolutionLadder(acc(d), levels=(4, 3)), "probs", "labels"),
        "ExponentialDecay": case(lambda d: M.ExponentialDecay(M.MeanSquaredError(device=d), halflife=8.0),
                                 "reg_p", "reg_t"),
        "QuantileSketch": case(lambda d: M.QuantileSketch(bins=64, device=d), "reg_p"),
        "HyperLogLog": case(lambda d: M.HyperLogLog(precision=6, device=d), "reg_p"),
        "CountMinHeavyHitters": case(lambda d: M.CountMinHeavyHitters(depth=2, width=64, device=d), "reg_p"),
        # audio (PESQ is host_only)
        "SignalNoiseRatio": case(lambda d: M.SignalNoiseRatio(device=d), "audio_p", "audio_t"),
        "ScaleInvariantSignalNoiseRatio": case(lambda d: M.ScaleInvariantSignalNoiseRatio(device=d),
                                               "audio_p", "audio_t"),
        "SignalDistortionRatio": case(lambda d: M.SignalDistortionRatio(device=d), "audio_p", "audio_t"),
        "ScaleInvariantSignalDistortionRatio": case(lambda d: M.ScaleInvariantSignalDistortionRatio(device=d),
                                                    "audio_p", "audio_t"),
        "ShortTimeObjectiveIntelligibility": case(lambda d: M.ShortTimeObjectiveIntelligibility(10000, device=d),
                                                  "stoi_p", "stoi_t"),
        "PermutationInvariantTraining": case(
            lambda d: M.PermutationInvariantTraining(F.scale_invariant_signal_noise_ratio, device=d),
            "pit_p", "pit_t"),
        # image (the net-backed classes are scoped out above)
        "PeakSignalNoiseRatio": case(lambda d: M.PeakSignalNoiseRatio(data_range=1.0, device=d),
                                     "ml_scores", "ml_scores"),
        "StructuralSimilarityIndexMeasure": case(lambda d: M.StructuralSimilarityIndexMeasure(device=d),
                                                 "img_p", "img_t"),
        "MultiScaleStructuralSimilarityIndexMeasure": case(
            lambda d: M.MultiScaleStructuralSimilarityIndexMeasure(device=d), "imgL_p", "imgL_t"),
        "UniversalImageQualityIndex": case(lambda d: M.UniversalImageQualityIndex(device=d), "img_p", "img_t"),
        "ErrorRelativeGlobalDimensionlessSynthesis": case(
            lambda d: M.ErrorRelativeGlobalDimensionlessSynthesis(device=d), "img_p", "img_t"),
        "SpectralAngleMapper": case(lambda d: M.SpectralAngleMapper(device=d), "img_p", "img_t"),
        "SpectralDistortionIndex": case(lambda d: M.SpectralDistortionIndex(device=d), "img_p", "img_t"),
    }
    # retrieval: (preds, target, indexes)
    for name in (
        "RetrievalFallOut", "RetrievalHitRate", "RetrievalMAP", "RetrievalMRR",
        "RetrievalNormalizedDCG", "RetrievalPrecision", "RetrievalRecall", "RetrievalRPrecision",
    ):
        t[name] = case(lambda d, c=getattr(M, name): c(device=d), "bin_scores", "bin_labels", "ret_idx")
    return t


def _wrapper_builds() -> Dict[str, Optional[Callable[..., Any]]]:
    import metrics_tpu_torch as M

    return {
        "BootStrapper": lambda d: M.BootStrapper(M.MeanSquaredError(device=d), num_bootstraps=2),
        "ClasswiseWrapper": lambda d: M.ClasswiseWrapper(M.Accuracy(num_classes=3, average=None, device=d)),
        "MinMaxMetric": lambda d: M.MinMaxMetric(M.MeanSquaredError(device=d)),
        "MultioutputWrapper": lambda d: M.MultioutputWrapper(M.MeanSquaredError(device=d), num_outputs=3),
        "MetricTracker": None,  # tracks a collection, not a self-contained Metric state
    }


# a kernel case's programs: fn(pool) -> the wrapper's output, at the JAX registry's shapes; where the kernel has a
# session axis (the JAX package's vmap of it), the case also runs that launch, at 3 sessions of the same rows
KernelPrograms = Dict[str, Callable[[Dict[str, torch.Tensor]], Any]]


def _kernel_table() -> Dict[str, Callable[[], KernelPrograms]]:
    from metrics_tpu_torch import ops

    def stat_inputs(pools: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        target = pools["labels"].to(torch.int32)
        pred = torch.roll(target, 1)
        return target, pred, pred == target, torch.ones(_B, dtype=torch.int32, device=target.device)

    def stat_scores() -> KernelPrograms:
        def sessions(pools):
            t, p, c, w = (x.expand(3, *x.shape).contiguous() for x in stat_inputs(pools))
            return ops.stat_scores_counts_sessions(t, p, c, w, _C)

        return {"plain": lambda pools: ops.stat_scores_counts(*stat_inputs(pools), _C), "sessions": sessions}

    def countmin_inputs(pools: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        dev = pools["labels"].device
        seeds = (torch.arange(2, dtype=torch.int64, device=dev) * 0x9E3779B9 + 1).to(torch.uint32)
        bits = pools["labels"].to(torch.uint32)
        return torch.zeros((2, 128), dtype=torch.float32, device=dev), bits, torch.ones(_B, device=dev), seeds

    def countmin() -> KernelPrograms:
        def sessions(pools):
            value, bits, w, seeds = countmin_inputs(pools)
            return ops.countmin_update_sessions(value.expand(3, 2, 128).contiguous(),
                                                bits.expand(3, _B).contiguous(), w.expand(3, _B).contiguous(), seeds)

        return {"plain": lambda pools: ops.countmin_update(*countmin_inputs(pools)), "sessions": sessions}

    def binned() -> KernelPrograms:
        def plain(pools):
            thresholds = torch.linspace(0.0, 1.0, 8, dtype=torch.float32, device=pools["probs"].device)
            return ops.binned_stat_scores(pools["probs"], pools["ml_labels"], thresholds)

        return {"plain": plain}

    def confusion() -> KernelPrograms:
        return {"plain": lambda pools: ops.confusion_matrix_counts(pools["labels"], pools["labels"], _C)}

    def retrieval() -> KernelPrograms:
        return {"plain": lambda pools: ops.sorted_by_preds(pools["bin_scores"][None], pools["bin_labels"][None])}

    def window_tick() -> KernelPrograms:
        import metrics_tpu_torch as M

        def plain(pools):
            dev = pools["probs"].device
            window = M.SlidingWindow(M.Accuracy(num_classes=_C, average="macro", device=dev), window=4, slide=2)
            return window.pure_update(window.default_state(), pools["probs"], pools["labels"])

        return {"plain": plain}

    return {
        "binned_stats": binned,
        "confusion_matrix": confusion,
        "countmin": countmin,
        "retrieval_sort": retrieval,
        "stat_scores": stat_scores,
        "window_tick": window_tick,
    }


def kernel_case_name(name: str) -> str:
    """A kernel's case name, ``ops.<the JAX package's registered name>``."""
    from metrics_tpu_torch.ops import registry as ops_registry

    return f"ops.{ops_registry.EVENT_NAMES.get(name, name)}"


def kernel_cases() -> List[AuditCase]:
    """Every :mod:`metrics_tpu_torch.ops` registry entry, as an audit case; a
    registered kernel with no entry here is an ``unclassified`` case (JX000)."""
    from metrics_tpu_torch.ops import registry as ops_registry

    table = _kernel_table()
    cases: List[AuditCase] = []
    for name in ops_registry.names():
        if name in table:
            cases.append(AuditCase(kernel_case_name(name), "kernel", table[name], None, ops_registry.get(name).doc))
        else:
            cases.append(AuditCase(kernel_case_name(name), "unclassified", None, None, "no kernel audit entry"))
    return cases


def audit_cases() -> List[AuditCase]:
    """Every exported :class:`~metrics_tpu_torch.metric.Metric` subclass,
    scoped, plus ``MeanAveragePrecision`` (exported by ``detection``)."""
    import metrics_tpu_torch as M
    from metrics_tpu_torch.detection import MeanAveragePrecision
    from metrics_tpu_torch.metric import Metric

    table = _device_table()
    wrappers = _wrapper_builds()
    cases: List[AuditCase] = []
    for name in M.__all__:
        obj = getattr(M, name)
        if not (inspect.isclass(obj) and issubclass(obj, Metric)):
            continue
        if name in _ABSTRACT:
            cases.append(AuditCase(name, "abstract", None, None, "base class"))
        elif getattr(obj, "host_only", False):
            cases.append(AuditCase(name, "host_only", None, None, "declared Metric.host_only"))
        elif name in _EXTRACTOR:
            cases.append(AuditCase(name, "extractor", None, None, "net-backed; structural facts only"))
        elif name in wrappers:
            cases.append(AuditCase(name, "wrapper", wrappers[name], None, "inner-metric state not in own state"))
        elif name in table:
            build, args = table[name]
            cases.append(AuditCase(name, "device", build, args))
        else:
            cases.append(AuditCase(name, "unclassified", None, None, "no registry entry"))
    if not getattr(MeanAveragePrecision, "host_only", False):
        raise AssertionError("MeanAveragePrecision must stay host_only")
    cases.append(AuditCase("MeanAveragePrecision", "host_only", None, None, "declared Metric.host_only"))
    return cases
