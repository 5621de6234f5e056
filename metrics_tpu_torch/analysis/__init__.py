"""Static analysis and cost accounting of the port's programs.

Port of ``metrics_tpu/analysis/``. The static audit proves the engines'
invariants instead of timing them, on two fronts that need no device:

* :mod:`~metrics_tpu_torch.analysis.program_audit` (the counterpart of
  ``jaxpr_audit``): traces every registered metric's ``pure_update``,
  ``pure_compute``, ``pure_merge`` and fused forward program on fake tensors
  and reports host syncs, dynamic shapes, unstable states, host copies and
  collectives, with the static collective schedule of the sync engine;
* :mod:`~metrics_tpu_torch.analysis.ast_lint`: an ``ast`` lint of the
  sources for host reads in pure paths, mutable state defaults and invalid
  reductions.

:mod:`~metrics_tpu_torch.analysis.registry` holds the cases both sweep,
:mod:`~metrics_tpu_torch.analysis.report` merges them into the checked-in
``STATIC_AUDIT_TORCH.json`` with a ratchet (``tools/torch_static_audit.py``),
and :mod:`~metrics_tpu_torch.analysis.hazards` is the read side the
engines use to tag compile spans with ``predicted``.

The runtime side: :mod:`~metrics_tpu_torch.analysis.cost_model`, a
registry of model flops and bytes per engine program and per kernel launch,
from which launch spans derive achieved rates and a roofline regime, and
:mod:`~metrics_tpu_torch.analysis.billing`, that registry priced in integer
microdollars.

Submodules load at first use, so importing this package costs nothing (the
engines import ``hazards`` at module load).
"""
import importlib

_SUBMODULES = ("ast_lint", "billing", "cost_model", "hazards", "program_audit", "registry", "report")

# the JAX package's names with another name here
RENAMED = {"jaxpr_audit": "program_audit"}

__all__ = list(_SUBMODULES)


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"metrics_tpu_torch.analysis.{name}")
    hint = f" (its counterpart is {RENAMED[name]!r})" if name in RENAMED else ""
    raise AttributeError(f"module 'metrics_tpu_torch.analysis' has no attribute {name!r}{hint}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
