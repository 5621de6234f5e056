"""Carry a metric's state between the JAX package and the port.

``metrics_tpu``'s ``Metric.state_dict()`` returns numpy leaves, ``aux:<name>``
entries (e.g. ``aux:mode = "multi-class"``) and ``__checksum__::<key>``
crc32 entries. The port writes the same checksum format, so one payload
verifies in both packages:

* :func:`load_jax_state_dict` verifies such a payload and loads its leaves
  into a port metric, on the metric's device;
* :func:`to_jax_state_dict` gives a port metric's state as such a payload,
  ready for the JAX metric's ``load_state_dict``.

Both also take a ``MetricCollection``: its payload's keys are
``<member>.<state>`` (and ``<member>.aux:<name>``), checksummed in one pass
over the whole payload, as the JAX package's collection writes them.

Only persistent states are written, as in both packages: call
``metric.persistent(True)`` on the writing side first.
"""
from typing import Any, Dict, Union

import torch

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.checksums import CHECKSUM_PREFIX, attach_checksums


def load_jax_state_dict(
    metric: Union[Metric, MetricCollection], payload: Dict[str, Any], strict: bool = True
) -> Union[Metric, MetricCollection]:
    """Verify ``payload``'s checksums, then load it into ``metric``."""
    metric.load_state_dict(payload, strict=strict)
    return metric


def _to_numpy(value: Any) -> Any:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, list):
        return [_to_numpy(v) for v in value]
    return value


def to_jax_state_dict(metric: Union[Metric, MetricCollection]) -> Dict[str, Any]:
    """``metric``'s persistent state as numpy leaves with checksums."""
    payload = {
        key: _to_numpy(value)
        for key, value in metric.state_dict().items()
        if not str(key).startswith(CHECKSUM_PREFIX)
    }
    return attach_checksums(payload)
