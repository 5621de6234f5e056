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
