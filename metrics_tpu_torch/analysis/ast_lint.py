"""Front 2: an ``ast`` lint of the port's metric sources for host reads in pure paths.

Port of ``metrics_tpu/analysis/ast_lint.py``. The program audit
(:mod:`~metrics_tpu_torch.analysis.program_audit`) proves what the traced
programs do on the example inputs; this front catches in the source, with
file and line, what would make an engine's program read the device back or
fail to capture, including code paths the example inputs never reach.

====== ==== =========================================================
MT101  P0   a host read of a tensor in a pure path (``float()``,
            ``int()``, ``bool()``, ``.item()``, ``.tolist()``, ``.cpu()``,
            ``.numpy()``): a sync on the card, and no CUDA graph holds it
MT102  P1   a Python ``if``/``while`` on metric state in a method body
            (a host sync, and a value-dependent path)
MT201  P0   a mutable ``add_state`` default (dict, set, non-empty list:
            shared across instances, never a valid state)
MT202  P1   an invalid ``dist_reduce_fx`` string (not sum/mean/cat/max/min)
MT301  P0   a raw ``numpy`` call on a tensor in a pure path (a silent
            device-to-host copy)
====== ==== =========================================================

MT401 (a host callback: ``jax.pure_callback``, ``jax.debug.print``) has no
torch counterpart: PyTorch runs Python between operations anyway, and a
callback inside a program is not an operation of the program. It is never
emitted.

"Pure paths" are the ``update``/``compute``/``pure_update``/
``pure_compute``/``pure_merge`` methods of metric classes and module-level
functional helpers named ``*_update``/``*_compute``. A value is "traced"
if it flows from a function parameter or from ``self.<state>``. Reads that
never touch data are exempt: the attributes ``.shape``, ``.ndim``,
``.dtype``, ``.device`` and the like, the methods ``numel()``, ``dim()``,
``size()`` and the like, ``len()``, ``isinstance()`` and shape arithmetic.
A host read under the port's concreteness guard,
:func:`metrics_tpu_torch.utilities.checks._is_traced` (``if not
_is_traced(): ...``, or a name assigned ``not _is_traced()`` and tested),
runs only outside an engine's program and is exempt too.
"""
import ast
import os
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Set

VALID_REDUCE_STRINGS = {"sum", "mean", "cat", "max", "min"}
PURE_METHOD_NAMES = {"update", "compute", "pure_update", "pure_compute", "pure_merge"}
# attribute reads on a traced value that stay metadata-only (host-safe)
METADATA_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout", "requires_grad", "itemsize"}
# tensor methods that read metadata only (host-safe)
METADATA_METHODS = {"size", "numel", "dim", "ndimension", "element_size", "is_floating_point", "is_complex",
                    "is_contiguous", "stride", "get_device", "nelement"}
CONVERSION_BUILTINS = {"float", "int", "bool", "complex"}
HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
# the port's concreteness guard: true while an engine builds or runs a program
GUARD_FUNCTIONS = {"_is_traced"}
# numpy attributes that are constants/types, not device->host calls
NUMPY_BENIGN = {
    "ndarray", "generic", "number", "dtype", "newaxis", "inf", "nan", "pi", "e",
    "float16", "float32", "float64", "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64", "bool_", "integer", "floating",
    "complexfloating", "errstate", "random",
}

SEVERITY = {"MT101": "P0", "MT102": "P1", "MT201": "P0", "MT202": "P1", "MT301": "P0"}


class Violation(NamedTuple):
    code: str
    severity: str
    path: str
    qualname: str
    lineno: int
    detail: str

    @property
    def key(self) -> str:
        """Stable ratchet identity: no line numbers (edits above a finding
        must not churn the baseline), path + qualname pin the site."""
        return f"{self.code}:{self.path}:{self.qualname}"


def _is_pure_function_name(name: str) -> bool:
    return name.endswith("_update") or name.endswith("_compute") or name in PURE_METHOD_NAMES


def _func_name(call: ast.Call) -> Optional[str]:
    if isinstance(call.func, ast.Name):
        return call.func.id
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return None


class _TracedExpr:
    """Does an expression (transitively) read traced data?"""

    def __init__(self, traced_names: Set[str], state_attrs: Set[str], numpy_aliases: Set[str]):
        self.traced_names = traced_names
        self.state_attrs = state_attrs
        self.numpy_aliases = numpy_aliases

    def check(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Attribute):
            if node.attr in METADATA_ATTRS:
                return False  # .shape/.dtype/... reads never move data
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                return node.attr in self.state_attrs
            return self.check(node.value)
        if isinstance(node, ast.Name):
            return node.id in self.traced_names
        if isinstance(node, ast.Call):
            fname = _func_name(node)
            if fname in ("len", "isinstance", "getattr", "hasattr", "range", "type"):
                return False
            if fname in METADATA_METHODS and isinstance(node.func, ast.Attribute):
                return False  # x.numel(), x.size(0), ... never move data
            # `preds.sum()` flows traced data through the receiver too
            recv = self.check(node.func.value) if isinstance(node.func, ast.Attribute) else False
            return recv or any(self.check(a) for a in node.args) or any(
                self.check(kw.value) for kw in node.keywords
            )
        return any(self.check(child) for child in ast.iter_child_nodes(node))


def _is_guard_call(node: ast.AST) -> bool:
    """``_is_traced()`` (possibly under ``not``)."""
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
        node = node.operand
    return isinstance(node, ast.Call) and _func_name(node) in GUARD_FUNCTIONS and not node.args


def _concreteness_exempt(fn: ast.AST) -> Set[int]:
    """Node ids dominated by the port's concreteness guard.

    ``check = not _is_traced()`` followed by ``if check and bool(...):``
    (or a direct ``if not _is_traced():``) runs host reads only outside an
    engine's program: eager-only validation, exempt from MT101/MT301/MT102.
    """
    guard_names: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and any(_is_guard_call(sub) for sub in ast.walk(node.value)):
            guard_names.update(t.id for t in node.targets if isinstance(t, ast.Name))

    def guarded(test: ast.AST) -> bool:
        for sub in ast.walk(test):
            if _is_guard_call(sub):
                return True
            if isinstance(sub, ast.Name) and sub.id in guard_names:
                return True
        return False
    exempt: Set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.If, ast.While, ast.IfExp)) and guarded(node.test):
            exempt.update(id(sub) for sub in ast.walk(node))
    return exempt


class _PurePathLinter(ast.NodeVisitor):
    """Lints ONE pure-path function body (MT101/MT102/MT301)."""

    def __init__(self, path: str, qualname: str, fn: ast.AST, state_attrs: Set[str],
                 numpy_aliases: Set[str], is_method: bool, out: List[Violation]):
        self.path, self.qualname, self.out = path, qualname, out
        self.numpy_aliases = numpy_aliases
        self.is_method = is_method
        args = fn.args
        traced = {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs} - {"self", "cls"}
        if args.vararg:
            traced.add(args.vararg.arg)
        self.tracker = _TracedExpr(traced, state_attrs if is_method else set(), numpy_aliases)
        self._exempt = _concreteness_exempt(fn)
        for stmt in fn.body:
            self.visit(stmt)

    def _emit(self, code: str, node: ast.AST, detail: str) -> None:
        if id(node) in self._exempt:
            return
        self.out.append(Violation(code, SEVERITY[code], self.path, self.qualname, node.lineno, detail))

    def visit_Call(self, node: ast.Call) -> None:
        fname = _func_name(node)
        if isinstance(node.func, ast.Name) and fname in CONVERSION_BUILTINS:
            if any(self.tracker.check(a) for a in node.args):
                self._emit("MT101", node, f"{fname}() on a traced value forces a host sync"
                           " (no CUDA graph can hold it)")
        elif isinstance(node.func, ast.Attribute) and fname in HOST_METHODS:
            if self.tracker.check(node.func.value):
                self._emit("MT101", node, f".{fname}() on a traced value copies it to the host (a sync)")
        if (
            isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in self.numpy_aliases
            and fname not in NUMPY_BENIGN
        ):
            if any(self.tracker.check(a) for a in node.args) or any(
                self.tracker.check(kw.value) for kw in node.keywords
            ):
                self._emit("MT301", node, f"raw numpy `{node.func.value.id}.{fname}` on a"
                           " traced value (a silent device-to-host copy)")
        self.generic_visit(node)

    @staticmethod
    def _value_reads(test: ast.AST):
        """Sub-expressions of a branch test that read VALUES — `x is None`
        identity tests are config-presence checks, not data reads."""
        if isinstance(test, ast.BoolOp):
            for v in test.values:
                yield from _PurePathLinter._value_reads(v)
        elif isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            yield from _PurePathLinter._value_reads(test.operand)
        elif isinstance(test, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops
        ):
            return
        else:
            yield test

    def _check_branch(self, node: Any) -> None:
        if self.is_method:
            # only flag when the test reads self-state VALUES; branching on
            # static config params (incl. `is None` presence tests) is fine
            t = _TracedExpr(set(), self.tracker.state_attrs, self.numpy_aliases)
            if any(t.check(sub) for sub in self._value_reads(node.test)):
                self._emit("MT102", node, "Python branch on metric state"
                           " (a host sync; a value-dependent path)")
        self.generic_visit(node)

    def visit_If(self, node: ast.If) -> None:
        self._check_branch(node)

    def visit_While(self, node: ast.While) -> None:
        self._check_branch(node)

    # nested defs get their own linting only if pure-path-named; don't descend
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    visit_AsyncFunctionDef = visit_FunctionDef


def _lint_add_state(call: ast.Call, path: str, qualname: str, out: List[Violation]) -> Optional[str]:
    """MT201/MT202 on one ``self.add_state(...)`` call; returns state name."""
    args = list(call.args)
    kwargs = {kw.arg: kw.value for kw in call.keywords if kw.arg}
    name_node = args[0] if args else kwargs.get("name")
    state_name = name_node.value if isinstance(name_node, ast.Constant) and isinstance(name_node.value, str) else None
    default = args[1] if len(args) > 1 else kwargs.get("default")
    if isinstance(default, (ast.Dict, ast.Set, ast.DictComp, ast.SetComp)) or (
        isinstance(default, (ast.List, ast.ListComp)) and getattr(default, "elts", True)
    ):
        out.append(Violation("MT201", SEVERITY["MT201"], path, qualname, call.lineno,
                             "mutable add_state default (only arrays or the EMPTY list are valid state)"))
    fx = args[2] if len(args) > 2 else kwargs.get("dist_reduce_fx")
    if isinstance(fx, ast.Constant) and isinstance(fx.value, str) and fx.value not in VALID_REDUCE_STRINGS:
        out.append(Violation("MT202", SEVERITY["MT202"], path, qualname, call.lineno,
                             f"invalid dist_reduce_fx {fx.value!r} (valid: {sorted(VALID_REDUCE_STRINGS)})"))
    return state_name


def _numpy_aliases(tree: ast.Module) -> Set[str]:
    aliases: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    aliases.add(a.asname or "numpy")
    return aliases


def lint_source(source: str, path: str = "<memory>") -> List[Violation]:
    """Lint one module's source text; the fixture tests feed this directly."""
    out: List[Violation] = []
    try:
        tree = ast.parse(source)
    except SyntaxError as err:
        out.append(Violation("MT000", "P0", path, "<module>", err.lineno or 0, f"does not parse: {err.msg}"))
        return out
    numpy_aliases = _numpy_aliases(tree)

    def lint_function(fn: ast.AST, qualname: str, state_attrs: Set[str], is_method: bool) -> None:
        _PurePathLinter(path, qualname, fn, state_attrs, numpy_aliases, is_method, out)

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _is_pure_function_name(node.name):
            lint_function(node, node.name, set(), is_method=False)
        elif isinstance(node, ast.ClassDef):
            # `host_only = True` classes run their update host-side by
            # declaration (and the dispatcher refuses them) — pure-path
            # rules do not apply inside them
            host_only = any(
                isinstance(n, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "host_only" for t in n.targets)
                and isinstance(n.value, ast.Constant) and n.value.value is True
                for n in node.body
            )
            state_attrs: Set[str] = set()
            methods = [n for n in node.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
            # pass 1: add_state declarations (anywhere in the class body)
            for meth in methods:
                qual = f"{node.name}.{meth.name}"
                for sub in ast.walk(meth):
                    if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute) \
                            and sub.func.attr == "add_state":
                        name = _lint_add_state(sub, path, qual, out)
                        if name:
                            state_attrs.add(name)
            # pass 2: pure-path methods with the full state-attr set known
            if not host_only:
                for meth in methods:
                    if meth.name in PURE_METHOD_NAMES:
                        lint_function(meth, f"{node.name}.{meth.name}", state_attrs, is_method=True)
    return out


def _default_roots() -> List[str]:
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return [pkg]


def lint_paths(paths: Optional[Sequence[str]] = None) -> List[Violation]:
    """Lint every ``metrics_tpu_torch`` source file (the analysis package
    itself is exempt: it *discusses* the violations). Paths in the result
    are relative to the repository root."""
    roots = list(paths) if paths else _default_roots()
    repo_root = os.path.dirname(_default_roots()[0])
    out: List[Violation] = []
    for root in roots:
        if os.path.isfile(root):
            files = [root]
        else:
            files = []
            for dirpath, dirnames, filenames in os.walk(root):
                dirnames[:] = [d for d in dirnames if d not in ("analysis", "__pycache__")]
                files.extend(os.path.join(dirpath, f) for f in sorted(filenames) if f.endswith(".py"))
        for fp in files:
            with open(fp, "r", encoding="utf-8") as fh:
                src = fh.read()
            rel = os.path.relpath(fp, repo_root)
            out.extend(lint_source(src, rel))
    return out
