"""Tweedie deviance score: port of ``metrics_tpu/functional/regression/tweedie_deviance.py``.

The JAX package checks the inputs' values only on concrete arrays, not
under ``jax.jit`` (``tweedie_deviance.py:20``); here the same checks are
skipped while an engine runs the update (:func:`_is_traced`), since each
reads the device back to the host. The observation count is returned as a
Python int (the JAX package's ``jnp.asarray(size)``), so that a captured
update copies nothing from the host.
"""
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utilities.checks import _check_same_shape, _is_traced


def _tweedie_deviance_score_update(preds: Tensor, targets: Tensor, power: float = 0.0) -> Tuple[Tensor, int]:
    """The summed deviance of the batch for ``power``, and its size."""
    _check_same_shape(preds, targets)

    if 0 < power < 1:
        raise ValueError(f"Deviance Score is not defined for power={power}.")

    check = not _is_traced()

    if power == 0:
        deviance_score = torch.square(targets - preds)
    elif power == 1:
        # Poisson distribution
        if check and (bool((preds <= 0).any()) or bool((targets < 0).any())):
            raise ValueError(
                f"For power={power}, 'preds' has to be strictly positive and 'targets' cannot be negative."
            )
        deviance_score = 2 * (torch.xlogy(targets, targets / preds) + preds - targets)
    elif power == 2:
        # Gamma distribution
        if check and (bool((preds <= 0).any()) or bool((targets <= 0).any())):
            raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")
        deviance_score = 2 * (torch.log(preds / targets) + (targets / preds) - 1)
    else:
        if power < 0:
            if check and bool((preds <= 0).any()):
                raise ValueError(f"For power={power}, 'preds' has to be strictly positive.")
        elif 1 < power < 2:
            if check and (bool((preds <= 0).any()) or bool((targets < 0).any())):
                raise ValueError(
                    f"For power={power}, 'targets' has to be strictly positive and 'preds' cannot be negative."
                )
        else:
            if check and (bool((preds <= 0).any()) or bool((targets <= 0).any())):
                raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")

        term_1 = torch.pow(torch.clamp(targets, min=0.0), 2 - power) / ((1 - power) * (2 - power))
        term_2 = targets * torch.pow(preds, 1 - power) / (1 - power)
        term_3 = torch.pow(preds, 2 - power) / (2 - power)
        deviance_score = 2 * (term_1 - term_2 + term_3)

    return torch.sum(deviance_score), deviance_score.numel()


def _tweedie_deviance_score_compute(sum_deviance_score: Tensor, num_observations: Tensor) -> Tensor:
    return sum_deviance_score / num_observations


def tweedie_deviance_score(preds: Tensor, targets: Tensor, power: float = 0.0) -> Tensor:
    """Tweedie deviance score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import tweedie_deviance_score
        >>> targets = torch.tensor([1.0, 2.0, 3.0, 4.0])
        >>> preds = torch.tensor([4.0, 3.0, 2.0, 1.0])
        >>> round(float(tweedie_deviance_score(preds, targets, power=2)), 4)
        1.2083
    """
    sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, power)
    return _tweedie_deviance_score_compute(sum_deviance_score, num_observations)
