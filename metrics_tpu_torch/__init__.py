"""PyTorch/CUDA port of ``metrics_tpu``.

The JAX package (``metrics_tpu``) stays the reference; this package
imports neither it nor ``jax``. Metrics keep their states on a CUDA device
unless given ``device="cpu"``; on the card their hot paths run hand-written
kernels (:mod:`metrics_tpu_torch.ops`), on the CPU the kernels' plain
PyTorch versions.
"""
from metrics_tpu_torch import functional  # noqa: F401
from metrics_tpu_torch.__about__ import __version__  # noqa: F401
from metrics_tpu_torch.aggregation import CatMetric, MaxMetric, MeanMetric, MinMetric, SumMetric  # noqa: F401
from metrics_tpu_torch.audio import (  # noqa: F401
    PerceptualEvaluationSpeechQuality,
    PermutationInvariantTraining,
    ScaleInvariantSignalDistortionRatio,
    ScaleInvariantSignalNoiseRatio,
    ShortTimeObjectiveIntelligibility,
    SignalDistortionRatio,
    SignalNoiseRatio,
)
from metrics_tpu_torch.classification.accuracy import Accuracy  # noqa: F401
from metrics_tpu_torch.classification.auc import AUC  # noqa: F401
from metrics_tpu_torch.classification.auroc import AUROC  # noqa: F401
from metrics_tpu_torch.classification.avg_precision import AveragePrecision  # noqa: F401
from metrics_tpu_torch.classification.binned_precision_recall import (  # noqa: F401
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    BinnedRecallAtFixedPrecision,
)
from metrics_tpu_torch.classification.calibration_error import CalibrationError  # noqa: F401
from metrics_tpu_torch.classification.cohen_kappa import CohenKappa  # noqa: F401
from metrics_tpu_torch.classification.confusion_matrix import ConfusionMatrix  # noqa: F401
from metrics_tpu_torch.classification.f_beta import F1Score, FBetaScore  # noqa: F401
from metrics_tpu_torch.classification.hamming import HammingDistance  # noqa: F401
from metrics_tpu_torch.classification.hinge import HingeLoss  # noqa: F401
from metrics_tpu_torch.classification.jaccard import JaccardIndex  # noqa: F401
from metrics_tpu_torch.classification.kl_divergence import KLDivergence  # noqa: F401
from metrics_tpu_torch.classification.matthews_corrcoef import MatthewsCorrCoef  # noqa: F401
from metrics_tpu_torch.classification.precision_recall import Precision, Recall  # noqa: F401
from metrics_tpu_torch.classification.precision_recall_curve import PrecisionRecallCurve  # noqa: F401
from metrics_tpu_torch.classification.ranking import (  # noqa: F401
    CoverageError,
    LabelRankingAveragePrecision,
    LabelRankingLoss,
)
from metrics_tpu_torch.classification.roc import ROC  # noqa: F401
from metrics_tpu_torch.classification.specificity import Specificity  # noqa: F401
from metrics_tpu_torch.classification.stat_scores import StatScores  # noqa: F401
from metrics_tpu_torch.collections import MetricCollection  # noqa: F401
from metrics_tpu_torch.image import (  # noqa: F401
    ErrorRelativeGlobalDimensionlessSynthesis,
    FrechetInceptionDistance,
    InceptionScore,
    KernelInceptionDistance,
    LearnedPerceptualImagePatchSimilarity,
    MultiScaleStructuralSimilarityIndexMeasure,
    PeakSignalNoiseRatio,
    SpectralAngleMapper,
    SpectralDistortionIndex,
    StructuralSimilarityIndexMeasure,
    UniversalImageQualityIndex,
)
from metrics_tpu_torch.metric import CompositionalMetric, Metric, StateCorruptionError  # noqa: F401
from metrics_tpu_torch.regression import (  # noqa: F401
    CosineSimilarity,
    ExplainedVariance,
    MeanAbsoluteError,
    MeanAbsolutePercentageError,
    MeanSquaredError,
    MeanSquaredLogError,
    PearsonCorrCoef,
    R2Score,
    SpearmanCorrCoef,
    SymmetricMeanAbsolutePercentageError,
    TweedieDevianceScore,
    WeightedMeanAbsolutePercentageError,
)
from metrics_tpu_torch.retrieval import (  # noqa: F401
    RetrievalFallOut,
    RetrievalHitRate,
    RetrievalMAP,
    RetrievalMetric,
    RetrievalMRR,
    RetrievalNormalizedDCG,
    RetrievalPrecision,
    RetrievalRecall,
    RetrievalRPrecision,
)
from metrics_tpu_torch.streaming import (  # noqa: F401
    CountMinHeavyHitters,
    ExponentialDecay,
    FoldTreeWindow,
    HostQuantileSketch,
    HyperLogLog,
    QuantileSketch,
    ResolutionLadder,
    SlidingWindow,
    TumblingWindow,
)
from metrics_tpu_torch.text import (  # noqa: F401
    BERTScore,
    BLEUScore,
    CharErrorRate,
    CHRFScore,
    ExtendedEditDistance,
    MatchErrorRate,
    ROUGEScore,
    SacreBLEUScore,
    SQuAD,
    TranslationEditRate,
    WordErrorRate,
    WordInfoLost,
    WordInfoPreserved,
)
from metrics_tpu_torch.wrappers import (  # noqa: F401
    BootStrapper,
    ClasswiseWrapper,
    MetricTracker,
    MinMaxMetric,
    MultioutputWrapper,
)

__all__ = [
    "AUC",
    "AUROC",
    "Accuracy",
    "AveragePrecision",
    "BERTScore",
    "BLEUScore",
    "BinnedAveragePrecision",
    "BinnedPrecisionRecallCurve",
    "BinnedRecallAtFixedPrecision",
    "BootStrapper",
    "CHRFScore",
    "CalibrationError",
    "CatMetric",
    "CharErrorRate",
    "ClasswiseWrapper",
    "CohenKappa",
    "CompositionalMetric",
    "ConfusionMatrix",
    "CosineSimilarity",
    "CountMinHeavyHitters",
    "CoverageError",
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "ExplainedVariance",
    "ExponentialDecay",
    "ExtendedEditDistance",
    "F1Score",
    "FBetaScore",
    "FoldTreeWindow",
    "FrechetInceptionDistance",
    "HammingDistance",
    "HingeLoss",
    "HostQuantileSketch",
    "HyperLogLog",
    "InceptionScore",
    "JaccardIndex",
    "KLDivergence",
    "KernelInceptionDistance",
    "LabelRankingAveragePrecision",
    "LabelRankingLoss",
    "LearnedPerceptualImagePatchSimilarity",
    "MatchErrorRate",
    "MatthewsCorrCoef",
    "MaxMetric",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanMetric",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "Metric",
    "MetricCollection",
    "MetricTracker",
    "MinMaxMetric",
    "MinMetric",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "MultioutputWrapper",
    "PeakSignalNoiseRatio",
    "PearsonCorrCoef",
    "PerceptualEvaluationSpeechQuality",
    "PermutationInvariantTraining",
    "Precision",
    "PrecisionRecallCurve",
    "QuantileSketch",
    "R2Score",
    "ROC",
    "ROUGEScore",
    "Recall",
    "ResolutionLadder",
    "RetrievalFallOut",
    "RetrievalHitRate",
    "RetrievalMAP",
    "RetrievalMRR",
    "RetrievalMetric",
    "RetrievalNormalizedDCG",
    "RetrievalPrecision",
    "RetrievalRPrecision",
    "RetrievalRecall",
    "SQuAD",
    "SacreBLEUScore",
    "ScaleInvariantSignalDistortionRatio",
    "ScaleInvariantSignalNoiseRatio",
    "ShortTimeObjectiveIntelligibility",
    "SignalDistortionRatio",
    "SignalNoiseRatio",
    "SlidingWindow",
    "SpearmanCorrCoef",
    "Specificity",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "StatScores",
    "StateCorruptionError",
    "StructuralSimilarityIndexMeasure",
    "SumMetric",
    "SymmetricMeanAbsolutePercentageError",
    "TranslationEditRate",
    "TumblingWindow",
    "TweedieDevianceScore",
    "UniversalImageQualityIndex",
    "WeightedMeanAbsolutePercentageError",
    "WordErrorRate",
    "WordInfoLost",
    "WordInfoPreserved",
    "functional",
]
