"""PearsonCorrCoef module metric: port of ``metrics_tpu/regression/pearson.py``.

The states are streaming moments declared with ``dist_reduce_fx=None``, so
a sync stacks them to ``(world, 1)``; :func:`_final_aggregation` merges the
stack in rank order, as the JAX package's ``lax.scan`` does, with the same
float32 operations.
"""
from typing import Any, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.regression.pearson import _pearson_corrcoef_compute, _pearson_corrcoef_update
from metrics_tpu_torch.metric import Metric


def _final_aggregation(
    means_x: Tensor,
    means_y: Tensor,
    vars_x: Tensor,
    vars_y: Tensor,
    corrs_xy: Tensor,
    nbs: Tensor,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Merge per-process ``(mean, M2, co-moment, n)`` stats, left to right.

    The states are unnormalised central moments, so the exact pairwise merge
    is Chan et al.'s parallel formula: ``M2 = M2_1 + M2_2 + n1 n2 / n (m1 -
    m2)^2``, and the same cross term for the co-moment.
    """
    mx1, my1, vx1, vy1, cxy1, n1 = means_x[0], means_y[0], vars_x[0], vars_y[0], corrs_xy[0], nbs[0]
    for i in range(1, means_x.shape[0]):
        mx2, my2, vx2, vy2, cxy2, n2 = means_x[i], means_y[i], vars_x[i], vars_y[i], corrs_xy[i], nbs[i]
        nb = n1 + n2
        frac = (n1 * n2) / nb
        mean_x = (n1 * mx1 + n2 * mx2) / nb
        mean_y = (n1 * my1 + n2 * my2) / nb
        var_x = vx1 + vx2 + frac * (mx1 - mx2) ** 2
        var_y = vy1 + vy2 + frac * (my1 - my2) ** 2
        corr_xy = cxy1 + cxy2 + frac * (mx1 - mx2) * (my1 - my2)
        mx1, my1, vx1, vy1, cxy1, n1 = mean_x, mean_y, var_x, var_y, corr_xy, nb
    return vx1, vy1, cxy1, n1


class PearsonCorrCoef(Metric):
    """Pearson correlation with O(1) streaming state.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PearsonCorrCoef
        >>> target = torch.tensor([3.0, -0.5, 2, 7])
        >>> preds = torch.tensor([2.5, 0.0, 2, 8])
        >>> pearson = PearsonCorrCoef(device="cpu")
        >>> round(float(pearson(preds, target)), 4)
        0.9849
    """

    is_differentiable = True
    higher_is_better = None
    full_state_update = True  # streaming moments cannot merge through a named reduction

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("mean_x", torch.zeros(1), dist_reduce_fx=None)
        self.add_state("mean_y", torch.zeros(1), dist_reduce_fx=None)
        self.add_state("var_x", torch.zeros(1), dist_reduce_fx=None)
        self.add_state("var_y", torch.zeros(1), dist_reduce_fx=None)
        self.add_state("corr_xy", torch.zeros(1), dist_reduce_fx=None)
        self.add_state("n_total", torch.zeros(1), dist_reduce_fx=None)

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total = _pearson_corrcoef_update(
            preds, target, self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total
        )

    def compute(self) -> Tensor:
        if self.mean_x.numel() > 1:  # stacked by a sync: (world, 1)
            var_x, var_y, corr_xy, n_total = _final_aggregation(
                self.mean_x.reshape(-1),
                self.mean_y.reshape(-1),
                self.var_x.reshape(-1),
                self.var_y.reshape(-1),
                self.corr_xy.reshape(-1),
                self.n_total.reshape(-1),
            )
        else:
            var_x, var_y, corr_xy, n_total = self.var_x, self.var_y, self.corr_xy, self.n_total
        return _pearson_corrcoef_compute(var_x, var_y, corr_xy, n_total)
