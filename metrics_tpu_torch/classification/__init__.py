from metrics_tpu_torch.classification.accuracy import Accuracy  # noqa: F401
from metrics_tpu_torch.classification.confusion_matrix import ConfusionMatrix  # noqa: F401
from metrics_tpu_torch.classification.stat_scores import StatScores  # noqa: F401
