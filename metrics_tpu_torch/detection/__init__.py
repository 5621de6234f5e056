"""Detection metrics: port of ``metrics_tpu/detection``."""
from metrics_tpu_torch.detection.helpers import box_area, box_convert, box_iou  # noqa: F401
from metrics_tpu_torch.detection.mean_ap import MeanAveragePrecision  # noqa: F401
