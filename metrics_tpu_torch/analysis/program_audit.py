"""Front 1: the program audit, every registered metric's pure paths traced on fake tensors.

The port's counterpart of ``metrics_tpu/analysis/jaxpr_audit.py``. For each
``device``-scope :class:`~metrics_tpu_torch.analysis.registry.AuditCase`
this module runs ``pure_update``, ``pure_compute``, ``pure_merge`` and the
fused forward engine's step program
(:func:`metrics_tpu_torch.forward_engine.audit_forward_program`) on the
example inputs made fake (``torch._subclasses.fake_tensor.FakeTensorMode``:
shapes, dtypes and devices propagate, no value exists), inside
:func:`metrics_tpu_torch.utilities.checks.tracing`, as the engines run a
program. Nothing executes and no device is needed. The fake tensors lie on
the CPU, so each kernel wrapper takes its plain version, which is what gets
traced; a wrapper reached with a fake CUDA tensor raises before any kernel
library is loaded.

The JAX rules map onto what a fake trace can see:

====== ==== =========================================================
JX000  P0   registry gap (an exported metric or a kernel with no case)
JX101  P1   a state leaf whose dtype or shape ``pure_update`` changes
JX201  P0   a host copy inside a pure path: ``.cpu()``, ``.numpy()``,
            ``.tolist()`` of a tensor, or a tensor made from host data on
            a device (``torch.tensor(x, device=...)``: on the card a
            host-to-device copy, which synchronises)
JX301  P0   a hidden host sync: a value read back to decide something
            (``.item()``, ``bool()``, ``int()``, ``float()`` on a tensor:
            ``DataDependentOutputException``), or a pure path that does
            not trace for another reason
JX401  P0   a dynamic-shape op (``nonzero``, boolean indexing, ``unique``:
            ``DynamicOutputShapeException``): its output's shape depends on
            values, which a captured CUDA graph cannot have
JX501  P1   a ``torch.distributed`` call inside update, compute, merge or
            forward (seen by a spy on the collectives)
====== ==== =========================================================

A fake trace models shapes, not the CUDA libraries, so a few operations
that trace cleanly cannot be captured in a CUDA graph on the card: they are
listed in :data:`CUDA_UNCAPTURABLE_OPS`, and a pure path that dispatches one
is a JX301 too. ``chip_smoke.py`` slice 21 holds every prediction of this
module against a capture on the card.

JX102 (a weak-typed state default) and JX103 (a state that widens under
x64) have no torch meaning: a torch tensor has no weak type, and no global
switch widens its dtype. They are never emitted.

The static collective schedule comes from the same planner the runtime
executes, :func:`metrics_tpu_torch.sync_engine.plan_metric_leaves` and
:func:`~metrics_tpu_torch.sync_engine.bucket_plan`, so its counts are the
counts ``chip_smoke.py`` slice 9 meets on the classification suite
(:func:`classification_suite_sync_plan`, the capstone).

``FakeTensorMode`` is a private API of PyTorch; this module was run under
torch 2.13 (CPU) and 2.11 (CUDA).
"""
import inspect
from contextlib import ExitStack, contextmanager
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from metrics_tpu_torch import sync_engine
from metrics_tpu_torch.analysis import registry
from metrics_tpu_torch.utilities.checks import tracing

# the torch.distributed entry points a spy replaces while a program is traced
COLLECTIVES = (
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object", "reduce_scatter",
    "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "broadcast", "broadcast_object_list", "reduce",
    "barrier", "gather", "scatter",
)
HOST_COPIES = {"cpu", "numpy", "tolist"}
# factories that copy host data to the device they are given (a sync on the card)
HOST_DATA_FACTORIES = {"tensor", "as_tensor"}
# aten operations whose CUDA implementation cannot be captured in a CUDA graph (seen on the card: the capture is
# invalidated and the engine demotes), which a fake trace cannot see
CUDA_UNCAPTURABLE_OPS = {
    "aten._linalg_solve_ex.default": "torch.linalg.solve_ex: cuSOLVER's batched LU invalidates a stream capture",
}


class Finding(NamedTuple):
    code: str
    severity: str  # P0 | P1 | P2
    metric: str
    where: str  # state name or program name
    detail: str

    @property
    def key(self) -> str:
        """Stable ratchet identity (no line numbers, no shapes)."""
        return f"{self.code}:{self.metric}:{self.where}"


class CollectiveCalled(RuntimeError):
    """A ``torch.distributed`` call met inside a traced pure path."""


def fake_mode() -> Any:
    """A fresh ``FakeTensorMode``; real tensors a metric holds (constants,
    its own buffers) are made fake where they meet a fake one."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def _is_fake(x: Any) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(x, FakeTensor)


class _HostCopySpy(TorchFunctionMode):
    """Counts the host copies a program makes: of a fake tensor to the host,
    and of host data (a number, a list, an array) to a named device."""

    def __init__(self) -> None:
        super().__init__()
        self.copies: List[str] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        kwargs = kwargs or {}
        if name in HOST_COPIES and args and _is_fake(args[0]):
            self.copies.append(name)
        elif name in HOST_DATA_FACTORIES and kwargs.get("device") is not None and args \
                and not isinstance(args[0], torch.Tensor):
            self.copies.append(f"{name}(host data, device=)")
        return func(*args, **kwargs)


class _OpCounter(TorchDispatchMode):
    """Counts the aten operations a program dispatches (the jaxpr's eqns),
    and notes those of :data:`CUDA_UNCAPTURABLE_OPS`."""

    def __init__(self) -> None:
        super().__init__()
        self.ops = 0
        self.uncapturable: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        if str(func) in CUDA_UNCAPTURABLE_OPS and str(func) not in self.uncapturable:
            self.uncapturable.append(str(func))
        return func(*args, **(kwargs or {}))


@contextmanager
def _spies() -> Iterator[Dict[str, Any]]:
    """Spy on ``torch.distributed``'s collectives (a call raises
    :class:`CollectiveCalled`) and on the kernel wrappers' routing rule
    (counted; a fake CUDA tensor raises before a kernel is reached)."""
    from metrics_tpu_torch.ops import registry as ops_registry

    seen: Dict[str, Any] = {"collectives": [], "kernel_routes": 0}
    saved = {name: getattr(dist, name) for name in COLLECTIVES if hasattr(dist, name)}
    route = ops_registry.use_kernel

    def spy(name: str) -> Callable:
        def call(*args: Any, **kwargs: Any) -> Any:
            seen["collectives"].append(name)
            raise CollectiveCalled(f"torch.distributed.{name} inside a pure path")

        return call

    def routed(*tensors: torch.Tensor) -> bool:
        seen["kernel_routes"] += 1
        if any(_is_fake(t) and t.device.type != "cpu" for t in tensors):
            raise RuntimeError("a kernel wrapper was reached with a fake CUDA tensor: the audit traces on the CPU")
        return route(*tensors)

    try:
        for name in saved:
            setattr(dist, name, spy(name))
        ops_registry.use_kernel = routed
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
        ops_registry.use_kernel = route


def _classify_trace_error(err: BaseException) -> Tuple[str, str]:
    """Map a failed fake trace to its rule code."""
    from torch._subclasses.fake_tensor import DataDependentOutputException, DynamicOutputShapeException

    if isinstance(err, CollectiveCalled):
        return "JX501", "collective inside a pure path"
    if isinstance(err, DynamicOutputShapeException):
        return "JX401", "dynamic-shape op (its output's shape depends on values)"
    if isinstance(err, DataDependentOutputException):
        return "JX301", "hidden host sync (reads a value back)"
    if isinstance(err, RuntimeError) and "numpy()" in str(err):
        return "JX301", "hidden host sync (copies a tensor to numpy)"
    return "JX301", f"pure path does not trace ({type(err).__name__})"


def _fakeify(mode: Any, tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return mode.from_tensor(tree)
    if isinstance(tree, dict):
        return {k: _fakeify(mode, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fakeify(mode, v) for v in tree)
    return tree


def _program_facts(fn: Callable, *trace_args: Any) -> Dict[str, Any]:
    """Trace one pure program on fake tensors; count what the rules read."""
    mode = fake_mode()
    counter, copies = _OpCounter(), _HostCopySpy()
    out, error = None, None
    with ExitStack() as stack:
        seen = stack.enter_context(_spies())
        stack.enter_context(tracing())
        stack.enter_context(mode)
        args = _fakeify(mode, trace_args)
        stack.enter_context(counter)
        stack.enter_context(copies)
        try:
            out = fn(*args)
        except Exception as err:  # noqa: BLE001 -- the failure IS the finding
            code, why = _classify_trace_error(err)
            error = {"rule": code, "type": type(err).__name__, "why": why}
    return {
        "error": error,
        "collectives": len(seen["collectives"]),
        "host_copies": copies.copies,
        "kernel_routes": seen["kernel_routes"],
        "ops": counter.ops,
        "uncapturable": counter.uncapturable,
        "out": out,
    }


def _leaf_facts(x: torch.Tensor) -> Dict[str, Any]:
    return {"dtype": str(x.dtype).replace("torch.", ""), "shape": list(x.shape)}


def _reduce_name(metric: Any, attr: str) -> Optional[str]:
    from metrics_tpu_torch.utilities.data import dim_zero_cat

    fx = metric._reductions.get(attr)
    if fx is None:
        return None
    native = sync_engine.NATIVE_REDUCE_OPS.get(fx)
    if native is not None:
        return native
    return "cat" if fx is dim_zero_cat else "custom"


def _update_hazards(metric: Any) -> Dict[str, bool]:
    """Signature-derived rebuild hazards (read by :mod:`.hazards`): a flag-like
    update parameter (a bool or str default) keys a new program a value."""
    static_key = False
    sig = inspect.signature(metric.update)
    for p in sig.parameters.values():
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        if isinstance(p.default, (bool, str)):
            static_key = True
    return {"static-key": static_key, "signature": False}  # signature set from the leaf facts


def _state_facts(metric: Any, state: Dict[str, Any]) -> Dict[str, Any]:
    facts: Dict[str, Any] = {}
    for attr, leaf in state.items():
        if isinstance(leaf, list):
            facts[attr] = {"list": True, "reduce": _reduce_name(metric, attr)}
        else:
            facts[attr] = {**_leaf_facts(leaf), "list": False, "reduce": _reduce_name(metric, attr)}
    return facts


def _program_findings(name: str, programs: Dict[str, Dict[str, Any]]) -> List[Finding]:
    findings: List[Finding] = []
    for prog, pf in programs.items():
        if pf["error"] is not None:
            severity = "P1" if pf["error"]["rule"] == "JX501" else "P0"
            findings.append(Finding(pf["error"]["rule"], severity, name, f"pure_{prog}",
                                    f"{pf['error']['why']} [{pf['error']['type']}]"))
        if pf.get("host_copies"):
            findings.append(Finding("JX201", "P0", name, f"pure_{prog}",
                                    f"host copies inside pure_{prog}: {', '.join(pf['host_copies'])}"))
        if pf["error"] is None and pf.get("uncapturable"):
            findings.append(Finding("JX301", "P0", name, f"pure_{prog}", "no CUDA graph can hold it: "
                                    + "; ".join(CUDA_UNCAPTURABLE_OPS[op] for op in pf["uncapturable"])))
    return findings


def sync_facts(metric: Any) -> Dict[str, Any]:
    """The metric's static collective schedule, by the runtime's planner."""
    states = {a: getattr(metric, a) for a in metric._reductions}
    specs = sync_engine.plan_metric_leaves(metric, states)
    buckets = sync_engine.bucket_plan(specs)
    return {
        "fused_collectives": len(buckets),
        "perleaf_collectives": len(specs),
        "buckets": {f"{k[0]}:{k[1]}": len(v) for k, v in sorted(buckets.items())},
        "sharded_buckets": sum(1 for k in buckets if k[0].startswith("rs[")),
        "unbucketed": sorted(
            a for a, v in states.items() if not isinstance(v, list) and a not in {s.key for s in specs}
        ),
    }


def audit_metric(case: registry.AuditCase, pools: Dict[str, Any]) -> Tuple[Dict[str, Any], List[Finding]]:
    """Facts and findings for one device-scope case (nothing executes)."""
    from metrics_tpu_torch import forward_engine

    metric = case.build("cpu")
    args = case.args(pools)
    name = case.name
    findings: List[Finding] = []
    state = metric.default_state()
    states_facts = _state_facts(metric, state)

    upd = _program_facts(lambda s, *a: metric.pure_update(s, *a), state, *args)
    programs: Dict[str, Dict[str, Any]] = {"update": upd}
    post_state = state
    if upd["error"] is None:
        out_state = upd.pop("out")
        for attr, leaf in state.items():
            sf = states_facts[attr]
            out_leaf = out_state[attr]
            if isinstance(leaf, list) or isinstance(out_leaf, list):
                sf["stable"] = False  # list states grow; the engines exclude them
                continue
            of = _leaf_facts(out_leaf)
            sf["stable"] = (of["dtype"], of["shape"]) == (sf["dtype"], sf["shape"])
            if not sf["stable"]:
                findings.append(Finding(
                    "JX101", "P1", name, attr,
                    f"update is no fixed point of the leaf's type: {sf['dtype']}{sf['shape']}"
                    f" -> {of['dtype']}{of['shape']}",
                ))
        # zeros of the post-update types let compute and merge trace, list states included
        post_state = {
            k: [torch.zeros(t.shape, dtype=t.dtype) for t in v] if isinstance(v, list)
            else torch.zeros(v.shape, dtype=v.dtype)
            for k, v in out_state.items()
        }
    else:
        upd.pop("out")

    comp = _program_facts(metric.pure_compute, post_state)
    comp.pop("out")
    programs["compute"] = comp
    merge = _program_facts(lambda a, b: metric.pure_merge(a, b), post_state, post_state)
    merge.pop("out")
    programs["merge"] = merge

    # the fused forward engine's step program, as the dispatcher builds it: only where the engine serves the
    # metric (every state a tensor, update and compute trace)
    if upd["error"] is None and comp["error"] is None and not any(isinstance(v, list) for v in state.values()):
        try:
            leaf_names, fwd_fn = forward_engine.audit_forward_program(metric)
            leaves = tuple(post_state[n] for n in leaf_names)
            fwd = _program_facts(fwd_fn, torch.tensor(1.0), leaves, *args)
        except Exception as err:  # noqa: BLE001 -- recorded; the engine degrades at run time
            fwd = {"error": {"rule": "JX301", "type": type(err).__name__, "why": "forward program does not build"},
                   "collectives": 0, "host_copies": [], "kernel_routes": 0, "ops": None, "uncapturable": [], "out": None}
        fwd.pop("out")
        programs["forward"] = fwd

    findings.extend(_program_findings(name, programs))
    hazards = _update_hazards(metric)
    hazards["signature"] = any(sf.get("list") is False and sf.get("stable") is False
                               for sf in states_facts.values()) or bool(upd["error"])
    return {"scope": case.scope, "states": states_facts, "programs": programs, "sync": sync_facts(metric),
            "hazards": hazards}, findings


def audit_kernel(case: registry.AuditCase, pools: Dict[str, Any]) -> Tuple[Dict[str, Any], List[Finding]]:
    """Facts and findings for one kernel case: each program (the wrapper, and
    its session axis where it has one) must trace on fake CPU tensors, through
    the kernel's plain version."""
    programs: Dict[str, Dict[str, Any]] = {}
    for prog, fn in case.build().items():
        pf = _program_facts(fn, pools)
        pf.pop("out")
        programs[prog] = pf
    findings = [
        Finding(pf["error"]["rule"], "P0", case.name, prog, f"{prog}: {pf['error']['why']}")
        for prog, pf in programs.items() if pf["error"] is not None
    ]
    return {"scope": "kernel", "states": {}, "programs": programs,
            "hazards": {"static-key": False, "signature": False}}, findings


def audit_structural(case: registry.AuditCase) -> Dict[str, Any]:
    """Facts for the other scopes: states where constructible, no traces."""
    facts: Dict[str, Any] = {"scope": case.scope, "states": {}, "programs": {},
                             "hazards": {"static-key": False, "signature": False}}
    if case.build is not None:
        metric = case.build("cpu")
        facts["states"] = _state_facts(metric, metric.default_state())
    return facts


def run_audit(cases: Optional[List[registry.AuditCase]] = None) -> Tuple[Dict[str, Any], List[Finding]]:
    """Sweep the registry (metrics and kernels): ``{name: facts}`` and every finding."""
    if cases is None:
        cases = registry.audit_cases() + registry.kernel_cases()
    pools = registry.example_inputs("cpu")
    all_facts: Dict[str, Any] = {}
    findings: List[Finding] = []
    empty = {"states": {}, "programs": {}, "hazards": {"static-key": False, "signature": False}}
    for case in cases:
        if case.scope in ("device", "kernel"):
            audit_one = audit_metric if case.scope == "device" else audit_kernel
            try:
                facts, fs = audit_one(case, pools)
            except Exception as err:  # noqa: BLE001 -- a broken case must not hide the rest
                facts = {"scope": case.scope, **empty}
                fs = [Finding("JX000", "P0", case.name, "registry",
                              f"audit case failed outside tracing: {type(err).__name__}: {err}")]
            all_facts[case.name] = facts
            findings.extend(fs)
        elif case.scope == "unclassified":
            all_facts[case.name] = {"scope": case.scope, **empty}
            findings.append(Finding("JX000", "P0", case.name, "registry",
                                    "exported Metric subclass or kernel with no audit classification"))
        else:
            all_facts[case.name] = audit_structural(case)
    return all_facts, findings


# ------------------------------------------------------------------ capstone
def collection_sync_plan(members: Dict[str, Any]) -> Dict[str, Any]:
    """The fused-sync collective schedule of a collection, by the planning
    calls ``MetricCollection``'s bucket pass makes: one collective a bucket,
    ``perleaf_collectives`` on the per-leaf path."""
    specs: List[Any] = []
    for name, m in members.items():
        states = {a: getattr(m, a) for a in m._reductions}
        specs.extend(sync_engine.plan_metric_leaves(m, states, tag=name))
    buckets = sync_engine.bucket_plan(specs)
    return {
        "fused_collectives": len(buckets),
        "perleaf_collectives": len(specs),
        "buckets": {f"{k[0]}:{k[1]}": len(v) for k, v in sorted(buckets.items())},
        "sharded_buckets": sum(1 for k in buckets if k[0].startswith("rs[")),
    }


def classification_suite(device: Any = "cpu", num_classes: int = 32) -> Dict[str, Any]:
    """The five-member classification suite of the JAX package's
    ``bench._cfg_sync_engine`` (and of ``chip_smoke.py`` slice 21's check)."""
    from metrics_tpu_torch import Accuracy, ConfusionMatrix, F1Score, Precision, Recall

    c = num_classes
    return {
        "acc": Accuracy(num_classes=c, average="macro", device=device),
        "f1": F1Score(num_classes=c, average="macro", device=device),
        "prec": Precision(num_classes=c, average="macro", device=device),
        "rec": Recall(num_classes=c, average="macro", device=device),
        "cm": ConfusionMatrix(num_classes=c, device=device),
    }


def classification_suite_sync_plan() -> Dict[str, Any]:
    """The capstone: the classification suite's static collective plan."""
    return collection_sync_plan(classification_suite())
