"""QD001/QD005: lock-guarded attribute and swap-guarded CAS discipline.

Field declarations carry a comment on the assignment line:

* ``# guarded by: self._lock`` — every read *and* write of the field
  must happen inside ``with self._lock:`` (QD001).
* ``# swap-guarded by: self._lock`` — only *writes* need the lock
  (QD005).  This is the atomic-pointer-snapshot pattern used by the
  ``LayoutService`` live-version CAS: readers take one reference
  lock-free (safe under the GIL's atomic attribute load) while every
  swap/rollback serializes through the lock and
  ``_swap_if_live_is``-style compare-and-set.

Module-level globals use the same convention with a module-level lock
(e.g. ``# guarded by: _pool_lock`` on the resident process-pool state).

Scoping rules:

* ``__init__`` / ``__new__`` / ``__post_init__`` are exempt — the
  object is not yet shared during construction.
* A method whose ``def`` line carries ``# qdlint: holds-lock`` is
  exempt: its contract is that every caller already holds the lock.
* Nested function and lambda bodies are skipped — they execute later,
  usually under a lock the enclosing scope arranges (callbacks,
  executor submissions), so flagging them would be noise.
"""

from __future__ import annotations

import ast
from typing import Optional

from repro_torch.analysis.core import Finding, ModuleInfo

_CTOR_NAMES = frozenset({"__init__", "__new__", "__post_init__"})
_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - defensive
        return ""


class _AccessVisitor(ast.NodeVisitor):
    """Walk one function body tracking which lock expressions are held.

    ``fields`` maps a guarded name to ``(locks, kind)``; ``attr_mode``
    selects whether guarded names are ``self.<name>`` attributes
    (class pass) or bare module globals (module pass).
    """

    def __init__(
        self,
        info: ModuleInfo,
        fields: dict[str, tuple[tuple[str, ...], str]],
        symbol: str,
        attr_mode: bool,
    ):
        self.info = info
        self.fields = fields
        self.symbol = symbol
        self.attr_mode = attr_mode
        self.held: set[str] = set()
        self.findings: list[Finding] = []

    # -- lock tracking -------------------------------------------------
    def _visit_with(self, node) -> None:
        added = set()
        for item in node.items:
            expr = _unparse(item.context_expr)
            if expr and expr not in self.held:
                added.add(expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        self.held |= added
        for stmt in node.body:
            self.visit(stmt)
        self.held -= added

    def visit_With(self, node: ast.With) -> None:
        self._visit_with(node)

    def visit_AsyncWith(self, node: ast.AsyncWith) -> None:
        self._visit_with(node)

    # -- deferred-execution scopes are out of bounds -------------------
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    def visit_AsyncFunctionDef(self, node) -> None:
        pass

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass

    def visit_Global(self, node: ast.Global) -> None:
        # `global _pool` re-declares the name without touching it
        pass

    # -- guarded accesses ----------------------------------------------
    def _check(self, node: ast.AST, name: str, is_store: bool) -> None:
        locks, kind = self.fields[name]
        if any(lock in self.held for lock in locks):
            return
        if kind == "swap" and not is_store:
            return  # lock-free reads of swap-guarded state are the point
        lock_desc = " or ".join(locks)
        if kind == "swap":
            code = "QD005"
            message = (
                f"swap-guarded attribute '{name}' assigned without "
                f"holding {lock_desc}"
            )
        else:
            code = "QD001"
            access = "written" if is_store else "read"
            message = (
                f"guarded attribute '{name}' {access} without "
                f"holding {lock_desc}"
            )
        self.findings.append(
            Finding(
                code=code,
                path=self.info.rel,
                line=node.lineno,
                col=node.col_offset,
                symbol=self.symbol,
                message=message,
            )
        )

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (
            self.attr_mode
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and node.attr in self.fields
        ):
            is_store = isinstance(node.ctx, (ast.Store, ast.Del))
            self._check(node, node.attr, is_store)
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if not self.attr_mode and node.id in self.fields:
            is_store = isinstance(node.ctx, (ast.Store, ast.Del))
            self._check(node, node.id, is_store)
        self.generic_visit(node)


def _guard_on_line(
    info: ModuleInfo, lineno: int
) -> Optional[tuple[tuple[str, ...], str]]:
    return info.guards.get(lineno)


def _collect_class_fields(
    info: ModuleInfo, cls: ast.ClassDef
) -> dict[str, tuple[tuple[str, ...], str]]:
    """Guarded ``self.<name>`` declarations anywhere in the class."""
    fields: dict[str, tuple[tuple[str, ...], str]] = {}
    for node in ast.walk(cls):
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        else:
            continue
        guard = _guard_on_line(info, node.lineno)
        if guard is None:
            continue
        for tgt in targets:
            if (
                isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self"
            ):
                fields[tgt.attr] = guard
    return fields


def _collect_module_globals(
    info: ModuleInfo,
) -> dict[str, tuple[tuple[str, ...], str]]:
    fields: dict[str, tuple[tuple[str, ...], str]] = {}
    for node in info.tree.body:
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        else:
            continue
        guard = _guard_on_line(info, node.lineno)
        if guard is None:
            continue
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                fields[tgt.id] = guard
    return fields


def _method_exempt(info: ModuleInfo, fn) -> bool:
    if fn.name in _CTOR_NAMES:
        return True
    return "holds-lock" in info.markers_on(fn.lineno)


def check_locks(info: ModuleInfo) -> list[Finding]:
    findings: list[Finding] = []

    # class pass: guarded self.<attr> fields per class
    for cls in [
        n for n in ast.walk(info.tree) if isinstance(n, ast.ClassDef)
    ]:
        fields = _collect_class_fields(info, cls)
        if not fields:
            continue
        for fn in cls.body:
            if not isinstance(fn, _FUNC_NODES):
                continue
            if _method_exempt(info, fn):
                continue
            visitor = _AccessVisitor(
                info, fields, f"{cls.name}.{fn.name}", attr_mode=True
            )
            for stmt in fn.body:
                visitor.visit(stmt)
            findings.extend(visitor.findings)

    # module pass: guarded globals across every function in the module
    globals_map = _collect_module_globals(info)
    if globals_map:
        for fn in [
            n for n in ast.walk(info.tree) if isinstance(n, _FUNC_NODES)
        ]:
            if _method_exempt(info, fn):
                continue
            visitor = _AccessVisitor(
                info, globals_map, fn.name, attr_mode=False
            )
            for stmt in fn.body:
                visitor.visit(stmt)
            findings.extend(visitor.findings)

    return findings
