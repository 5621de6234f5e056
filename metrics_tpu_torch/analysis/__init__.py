"""Cost accounting for the port's programs and kernels.

Port of the runtime side of ``metrics_tpu/analysis/``:

* :mod:`~metrics_tpu_torch.analysis.cost_model`: a registry of model flops
  and bytes per engine program and per kernel launch, from which launch
  spans derive achieved GFLOP/s and GB/s and a roofline regime;
* :mod:`~metrics_tpu_torch.analysis.billing`: that registry priced in
  integer microdollars (the serving stack's cost attribution);
* :mod:`~metrics_tpu_torch.analysis.hazards`: the read side of the
  checked-in ``STATIC_AUDIT.json``, which tags compile spans with
  ``predicted``.

The static-audit harness of the JAX package (``jaxpr_audit``,
``ast_lint``, ``registry``, ``report``) is not ported: asking for it
raises ``AttributeError`` naming ROADMAP.md, Queue A item 13.

Submodules load at first use, so importing this package costs nothing.
"""
import importlib

_SUBMODULES = ("billing", "cost_model", "hazards")

__all__ = list(_SUBMODULES)


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"metrics_tpu_torch.analysis.{name}")
    raise AttributeError(
        f"module 'metrics_tpu_torch.analysis' has no attribute {name!r} (the static audit, ROADMAP.md,"
        " Queue A item 13, is not ported)"
    )


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
