from metrics_tpu_torch.functional.classification.accuracy import accuracy  # noqa: F401
from metrics_tpu_torch.functional.classification.average_precision import average_precision  # noqa: F401
from metrics_tpu_torch.functional.classification.cohen_kappa import cohen_kappa  # noqa: F401
from metrics_tpu_torch.functional.classification.confusion_matrix import confusion_matrix  # noqa: F401
from metrics_tpu_torch.functional.classification.jaccard import jaccard_index  # noqa: F401
from metrics_tpu_torch.functional.classification.matthews_corrcoef import matthews_corrcoef  # noqa: F401
from metrics_tpu_torch.functional.classification.precision_recall_curve import precision_recall_curve  # noqa: F401
from metrics_tpu_torch.functional.classification.stat_scores import stat_scores  # noqa: F401
