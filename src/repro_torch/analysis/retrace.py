"""QD003/QD004: recompile hazards in compiled bodies and host syncs in
hot paths.

QD003 has two legs:

* **Branching on tensor values.**  Inside a ``torch.compile``d function,
  an ``if``/``while`` on a tensor parameter is a graph break at best and
  a guard that recompiles once per value at worst.  Checked bodies are
  functions decorated ``@torch.compile`` (bare or called, with any
  options) or ``@functools.partial(torch.compile, ...)``, plus functions
  marked ``# qdlint: jit-body`` on the ``def`` line (convention:
  positional parameters are tensors, keyword-only parameters are
  Python values).  In a compiled body a parameter counts as a tensor
  unless its annotation names a Python scalar (``int``, ``float``,
  ``bool``, ``str``).  Branches on such parameters and on locals are
  allowed (locals are under-approximated as safe).
* **PlanKey buckets bypassing pad_bucket.**  The zero-warm-plan-builds
  contract holds because every plan cache key quantizes its shape
  coordinates (``m_bucket``/``node_bucket``/``leaf_bucket``/
  ``cut_bucket``) through :func:`repro_torch.engine.plan.pad_bucket`.
  A ``PlanKey(...)`` whose bucket argument is a raw value keys the cache
  on exact shapes — one plan build per batch size.  Accepted: integer
  literals, expressions containing a ``pad_bucket`` call, and names
  assigned (transitively) from such expressions within the function.

QD004 flags host-synchronizing calls — ``float(x)``, ``x.item()``,
``x.cpu()``, ``x.numpy()``, ``x.tolist()``, ``torch.cuda.synchronize()``
and ``np.asarray`` / ``np.array`` — inside functions whose ``def`` line
is marked ``# qdlint: hot-path``.  Each one blocks on the device and
drags the result across the host boundary; hot paths must stay on the
device (``torch.as_tensor`` is fine).
"""

from __future__ import annotations

import ast
from typing import Optional

from repro_torch.analysis.core import Finding, ModuleInfo

_BUCKET_FIELDS = ("m_bucket", "node_bucket", "leaf_bucket", "cut_bucket")
# PlanKey(sig, backend, m_bucket, node_bucket, leaf_bucket, cut_bucket, opts)
_BUCKET_POSITIONS = {2: "m_bucket", 3: "node_bucket",
                     4: "leaf_bucket", 5: "cut_bucket"}

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

# QD004: methods that copy a device tensor to the host, calls that wait
# for the device, and host-array constructors
_SYNC_METHODS = frozenset({"item", "cpu", "numpy", "tolist"})
_SYNC_CALLS = frozenset({"torch.cuda.synchronize"})
_HOST_COPIES = frozenset({"np.asarray", "numpy.asarray", "np.array",
                          "numpy.array"})


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of an expression ('' when not a name)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


def _is_compile(node: ast.AST) -> bool:
    return _dotted(node) in ("torch.compile", "compile")


# annotations of parameters a compiled body takes as Python values
_PY_SCALARS = frozenset({"int", "float", "bool", "str"})


def _tensor_params(names: list) -> set[str]:
    return {a.arg for a in names
            if a.annotation is None
            or _dotted(a.annotation) not in _PY_SCALARS}


def _compiled_tensor_params(info: ModuleInfo, fn) -> Optional[set[str]]:
    """Tensor parameter names if ``fn`` is a compiled body, else None."""
    for dec in fn.decorator_list:
        compiled = _is_compile(dec) or (
            isinstance(dec, ast.Call) and (
                _is_compile(dec.func)
                or (_dotted(dec.func) in ("functools.partial", "partial")
                    and dec.args and _is_compile(dec.args[0]))))
        if compiled:
            return _tensor_params(fn.args.posonlyargs + fn.args.args
                                  + fn.args.kwonlyargs)
    if "jit-body" in info.markers_on(fn.lineno):
        # convention: positional parameters tensors, keyword-only static
        return {a.arg for a in fn.args.posonlyargs + fn.args.args}
    return None


class _NameFinder(ast.NodeVisitor):
    def __init__(self):
        self.names: set[str] = set()
        self.calls: set[str] = set()

    def visit_Name(self, node: ast.Name) -> None:
        self.names.add(node.id)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func)
        if dotted:
            self.calls.add(dotted)
        self.generic_visit(node)


def _expr_names(node: ast.AST) -> tuple[set[str], set[str]]:
    finder = _NameFinder()
    finder.visit(node)
    return finder.names, finder.calls


def _has_pad_bucket_call(calls: set[str]) -> bool:
    return any(
        c == "pad_bucket" or c.endswith(".pad_bucket") for c in calls
    )


def _pad_derived_names(fn) -> set[str]:
    """Names assigned (transitively) from pad_bucket expressions."""
    assigns: list[tuple[str, ast.AST]] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            assigns.append((node.targets[0].id, node.value))
        elif isinstance(node, ast.AnnAssign) and isinstance(
            node.target, ast.Name
        ) and node.value is not None:
            assigns.append((node.target.id, node.value))
    derived: set[str] = set()
    changed = True
    while changed:
        changed = False
        for name, value in assigns:
            if name in derived:
                continue
            names, calls = _expr_names(value)
            if _has_pad_bucket_call(calls) or (names & derived):
                derived.add(name)
                changed = True
    return derived


def _bucket_arg_ok(node: ast.AST, derived: set[str]) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return True
    names, calls = _expr_names(node)
    return _has_pad_bucket_call(calls) or bool(names & derived)


def check_retrace(info: ModuleInfo) -> list[Finding]:
    findings: list[Finding] = []

    def flag(code: str, node: ast.AST, symbol: str, message: str):
        findings.append(
            Finding(
                code=code,
                path=info.rel,
                line=node.lineno,
                col=node.col_offset,
                symbol=symbol,
                message=message,
            )
        )

    for fn in [
        n for n in ast.walk(info.tree) if isinstance(n, _FUNC_NODES)
    ]:
        # QD003a: Python branches on tensors inside compiled bodies
        traced = _compiled_tensor_params(info, fn)
        if traced:
            for node in ast.walk(fn):
                if isinstance(node, (ast.If, ast.While)):
                    names, _ = _expr_names(node.test)
                    hot = sorted(names & traced)
                    if hot:
                        flag(
                            "QD003", node, fn.name,
                            "Python-level branch on tensor value(s) "
                            f"{', '.join(hot)} inside a compiled body — "
                            "a graph break or one recompile per value; "
                            "use torch.where or pass a Python value",
                        )

        # QD003b: PlanKey buckets must flow through pad_bucket
        derived: Optional[set[str]] = None
        for node in ast.walk(fn):
            if not (
                isinstance(node, ast.Call)
                and _dotted(node.func).split(".")[-1] == "PlanKey"
            ):
                continue
            if derived is None:
                derived = _pad_derived_names(fn)
            suspects: list[tuple[str, ast.AST]] = []
            for pos, name in _BUCKET_POSITIONS.items():
                if pos < len(node.args):
                    suspects.append((name, node.args[pos]))
            for kw in node.keywords:
                if kw.arg in _BUCKET_FIELDS:
                    suspects.append((kw.arg, kw.value))
            for name, arg in suspects:
                if not _bucket_arg_ok(arg, derived):
                    flag(
                        "QD003", arg, fn.name,
                        f"PlanKey {name} not derived from pad_bucket — "
                        "raw shapes defeat the padding-bucket plan "
                        "cache (one plan build per distinct size)",
                    )

        # QD004: host syncs inside hot-path functions
        if "hot-path" not in info.markers_on(fn.lineno):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Name) and func.id == "float" \
                    and len(node.args) == 1:
                flag(
                    "QD004", node, fn.name,
                    "float(...) in a hot-path function forces a host "
                    "sync on device tensors",
                )
            elif isinstance(func, ast.Attribute):
                dotted = _dotted(func)
                if func.attr in _SYNC_METHODS and not node.args:
                    flag(
                        "QD004", node, fn.name,
                        f".{func.attr}() in a hot-path function forces a "
                        "host sync",
                    )
                elif dotted in _SYNC_CALLS:
                    flag(
                        "QD004", node, fn.name,
                        f"{dotted}(...) in a hot-path function waits "
                        "for the device",
                    )
                elif dotted in _HOST_COPIES:
                    flag(
                        "QD004", node, fn.name,
                        f"{dotted}(...) in a hot-path function "
                        "pulls device tensors to host",
                    )
    return findings
