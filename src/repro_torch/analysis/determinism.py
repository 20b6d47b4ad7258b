"""QD002: hash-seed / wall-clock determinism inside deterministic modules.

Modules carrying ``# qdlint: deterministic-module`` promise bit-identical
outputs across processes — the contract every ShardState/TrackerState
merge, replica signature, and plan fingerprint relies on.  Two bug
classes silently break it:

* **Unsorted set iteration.**  ``for k in set(a) | set(b)`` iterates in
  hash order, which varies per process under ``PYTHONHASHSEED``
  randomization for str keys — exactly the spawn-worker topology the
  process executor uses.  Any iteration over a set expression must go
  through ``sorted(...)``.  Plain ``dict`` (and ``.keys()``) iteration
  is insertion-ordered and therefore deterministic; ``.keys()`` only
  counts as set-ish inside set algebra (``a.keys() & b.keys()``), where
  the result is a real set again.
* **Wall clock / unseeded randomness.**  ``time.time()`` /
  ``time.time_ns()`` and ``random.*`` / unseeded ``np.random.*`` calls
  leak nondeterminism into outputs.  ``time.perf_counter()`` is fine
  (used for reported timings, never for data), and seeded generator
  *construction* (``np.random.default_rng(seed)``, ``Generator``,
  ``SeedSequence``, bit generators) is the sanctioned idiom.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.core import Finding, ModuleInfo

# iteration wrappers that materialize their argument's order
_ORDER_SINKS = frozenset({"list", "tuple", "enumerate", "iter"})

# np.random constructors that take an explicit seed — allowed
_SEEDED_RNG = frozenset(
    {"default_rng", "Generator", "SeedSequence", "PCG64", "Philox",
     "MT19937", "SFC64"}
)

_SET_OPS = (ast.BitOr, ast.BitAnd, ast.BitXor, ast.Sub)


def _is_keys_call(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "keys"
    )


def _is_set_expr(node: ast.AST) -> bool:
    """Does ``node`` evaluate to a set/frozenset?"""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id in ("set", "frozenset")
    ):
        return True
    if isinstance(node, ast.BinOp) and isinstance(node.op, _SET_OPS):
        # dict-view algebra (a.keys() & b) also yields a set
        for side in (node.left, node.right):
            if _is_set_expr(side) or _is_keys_call(side):
                return True
    return False


def check_determinism(info: ModuleInfo) -> list[Finding]:
    if not info.deterministic:
        return []
    findings: list[Finding] = []
    symbol_stack: list[str] = []

    def symbol() -> str:
        return ".".join(symbol_stack) if symbol_stack else "<module>"

    def flag(node: ast.AST, message: str) -> None:
        findings.append(
            Finding(
                code="QD002",
                path=info.rel,
                line=node.lineno,
                col=node.col_offset,
                symbol=symbol(),
                message=message,
            )
        )

    def check_iter_source(node: ast.AST) -> None:
        if _is_set_expr(node):
            flag(
                node,
                "iteration over an unordered set expression; wrap it "
                "in sorted(...) for hash-seed-independent order",
            )

    def visit(node: ast.AST) -> None:
        pushed = False
        if isinstance(
            node,
            (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
        ):
            symbol_stack.append(node.name)
            pushed = True

        if isinstance(node, (ast.For, ast.AsyncFor)):
            check_iter_source(node.iter)
        elif isinstance(
            node,
            (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp),
        ):
            for gen in node.generators:
                check_iter_source(gen.iter)
        elif isinstance(node, ast.Call):
            func = node.func
            if (
                isinstance(func, ast.Name)
                and func.id in _ORDER_SINKS
                and len(node.args) >= 1
            ):
                check_iter_source(node.args[0])
            if isinstance(func, ast.Attribute):
                base = func.value
                if isinstance(base, ast.Name):
                    if base.id == "time" and func.attr in (
                        "time", "time_ns"
                    ):
                        flag(
                            node,
                            f"wall-clock call time.{func.attr}() in a "
                            "deterministic module",
                        )
                    elif base.id == "random":
                        flag(
                            node,
                            f"unseeded random.{func.attr}() in a "
                            "deterministic module",
                        )
                elif (
                    isinstance(base, ast.Attribute)
                    and base.attr == "random"
                    and isinstance(base.value, ast.Name)
                    and base.value.id in ("np", "numpy")
                    and func.attr not in _SEEDED_RNG
                ):
                    flag(
                        node,
                        f"unseeded {base.value.id}.random.{func.attr}()"
                        " in a deterministic module; construct a seeded"
                        " Generator via default_rng(seed) instead",
                    )

        for child in ast.iter_child_nodes(node):
            visit(child)
        if pushed:
            symbol_stack.pop()

    visit(info.tree)
    return findings
