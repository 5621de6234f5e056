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

The JAX package runs with x64 off, so its counts are int32. A port count
kept in int64 (``Metric._int64_states``, e.g. ``PeakSignalNoiseRatio``'s
``total``) is widened from the payload's int32 on loading, and narrowed to
int32 on export; a count int32 cannot hold raises ``OverflowError`` there
instead of wrapping.
"""
from typing import Any, Dict, Iterator, Tuple, Union

import torch

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.checksums import CHECKSUM_PREFIX, attach_checksums


def _int64_states(metric: Union[Metric, MetricCollection]) -> Iterator[Tuple[str, Metric, str]]:
    """``(payload key, metric, state)`` of every ``_int64_states`` entry in
    ``metric``'s tree, keyed as its ``state_dict`` keys them."""
    stack = (
        [(f"{name}.", m) for name, m in metric.items(keep_base=True)]
        if isinstance(metric, MetricCollection)
        else [("", metric)]
    )
    while stack:
        prefix, m = stack.pop()
        yield from ((prefix + name, m, name) for name in m._int64_states)
        stack.extend((f"{prefix}{name}.", child) for name, child in m._children())


def _widen(value: Any) -> Any:
    if isinstance(value, list):
        return [_widen(v) for v in value]
    return value.to(torch.int64) if value.dtype == torch.int32 else value


def _narrow(value: Any, key: str) -> Any:
    if isinstance(value, list):
        return [_narrow(v, key) for v in value]
    info = torch.iinfo(torch.int32)
    if value.numel() and bool((value < info.min).any() or (value > info.max).any()):
        raise OverflowError(
            f"state {key!r} holds a count past int32, which the JAX package's state (x64 off) cannot hold"
        )
    return value.to(torch.int32)


def load_jax_state_dict(
    metric: Union[Metric, MetricCollection], payload: Dict[str, Any], strict: bool = True
) -> Union[Metric, MetricCollection]:
    """Verify ``payload``'s checksums, then load it into ``metric``; the
    int32 counts of ``_int64_states`` come in as int64."""
    metric.load_state_dict(payload, strict=strict)
    for _, m, name in _int64_states(metric):
        object.__setattr__(m, name, _widen(getattr(m, name)))
    return metric


def _to_numpy(value: Any) -> Any:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, list):
        return [_to_numpy(v) for v in value]
    return value


def to_jax_state_dict(metric: Union[Metric, MetricCollection]) -> Dict[str, Any]:
    """``metric``'s persistent state as numpy leaves with checksums."""
    payload = {key: value for key, value in metric.state_dict().items() if not str(key).startswith(CHECKSUM_PREFIX)}
    for key, _, _ in _int64_states(metric):
        if key in payload:
            payload[key] = _narrow(payload[key], key)
    payload = {key: _to_numpy(value) for key, value in payload.items()}
    return attach_checksums(payload)
