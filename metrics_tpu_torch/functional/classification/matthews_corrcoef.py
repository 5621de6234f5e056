"""Matthews correlation coefficient: port of ``metrics_tpu/functional/classification/matthews_corrcoef.py``."""
import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.confusion_matrix import _confusion_matrix_update

_matthews_corrcoef_update = _confusion_matrix_update


def _matthews_corrcoef_compute(confmat: Tensor) -> Tensor:
    """The multiclass MCC from a confusion matrix; 0 where a marginal is constant."""
    tk = confmat.sum(dim=1).to(torch.float32)
    pk = confmat.sum(dim=0).to(torch.float32)
    c = torch.trace(confmat).to(torch.float32)
    s = confmat.sum().to(torch.float32)

    cov_ytyp = c * s - torch.sum(tk * pk)
    cov_ypyp = s**2 - torch.sum(pk * pk)
    cov_ytyt = s**2 - torch.sum(tk * tk)

    denom = cov_ypyp * cov_ytyt
    return torch.where(denom == 0, 0.0, cov_ytyp / torch.sqrt(torch.where(denom == 0, 1.0, denom)))


def matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    threshold: float = 0.5,
) -> Tensor:
    """Matthews correlation coefficient.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import matthews_corrcoef
        >>> round(float(matthews_corrcoef(torch.tensor([0, 1, 0, 0]), torch.tensor([1, 1, 0, 0]), num_classes=2)), 4)
        0.5774
    """
    confmat = _matthews_corrcoef_update(preds, target, num_classes, threshold)
    return _matthews_corrcoef_compute(confmat)
