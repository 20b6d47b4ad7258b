"""qdlint core: findings, source annotations, suppressions, baseline, runner.

qdlint is an AST-based static-analysis pass for the invariants the rest
of the stack *assumes* but nothing else enforces at the source level:

* **QD001 lock discipline** — attributes declared ``# guarded by:
  self._lock`` touched outside a ``with self._lock:`` block.
* **QD002 determinism** — unsorted iteration over set expressions, and
  wall-clock / unseeded randomness, inside modules declared
  ``# qdlint: deterministic-module`` (the bit-identity contract behind
  every ShardState/TrackerState merge and replica fold).
* **QD003 recompile hazard** — Python branches on tensor parameters
  inside ``torch.compile`` bodies, and ``PlanKey`` bucket arguments
  that bypass ``pad_bucket`` (the zero-warm-plan-builds contract).
* **QD004 host-sync hazard** — ``float()`` / ``.item()`` / ``.cpu()`` /
  ``.numpy()`` / ``.tolist()`` / ``torch.cuda.synchronize()`` /
  ``np.asarray()`` device syncs inside functions marked
  ``# qdlint: hot-path``.
* **QD005 epoch/CAS discipline** — writes to ``# swap-guarded by:``
  state (the atomically-snapshotted live pointer) outside the lock;
  lock-free *reads* of such state are sanctioned by design.

Annotations are plain comments so the checked modules carry no runtime
dependency on this package; the package itself is stdlib-only, so it
runs with nothing but ``PYTHONPATH=src``.

Suppression: ``# qdlint: disable=QD001,QD002 <reason>`` on the finding
line.  The reason text is REQUIRED — a bare disable is ignored (and the
finding still fires), so every suppression documents *why* the contract
does not apply.

Baseline: a committed JSON file of finding fingerprints
(``{code}::{path}::{symbol}::{message}`` — line-number-free so it
survives unrelated edits).  Findings absorbed by the baseline are
reported separately and do not fail the run.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import pathlib
import re
from collections import Counter
from typing import Iterable, Optional, Sequence

CHECKER_CODES = ("QD001", "QD002", "QD003", "QD004", "QD005")

#: path fragments never scanned (the fixture corpora are deliberately
#: full of violations; scanning them would drown real findings).  This
#: package's own fixtures are ``*.py.txt``, which no directory scan
#: picks up (nor ``ruff``, nor the JAX package's qdlint over ``src``).
EXCLUDED_FRAGMENTS = ("repro/analysis/fixtures/",
                      "repro_torch/analysis/fixtures/")

_LOCK_LIST = r"[A-Za-z_][\w.]*(?:\s*,\s*[A-Za-z_][\w.]*)*"
_SWAP_RE = re.compile(rf"#\s*swap-guarded by:\s*(?P<locks>{_LOCK_LIST})")
_GUARD_RE = re.compile(rf"#\s*guarded by:\s*(?P<locks>{_LOCK_LIST})")
_MARKER_RE = re.compile(
    r"#\s*qdlint:\s*(?P<marker>hot-path|holds-lock|jit-body|"
    r"deterministic-module)\b"
)
_SUPPRESS_RE = re.compile(
    r"#\s*qdlint:\s*disable=(?P<codes>QD\d{3}(?:\s*,\s*QD\d{3})*)"
    r"\s*(?P<reason>.*)$"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    code: str
    path: str
    line: int
    col: int
    symbol: str
    message: str

    def fingerprint(self) -> str:
        """Line-number-free identity used by the baseline file."""
        return f"{self.code}::{self.path}::{self.symbol}::{self.message}"

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: {self.code} "
            f"[{self.symbol}] {self.message}"
        )

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ModuleInfo:
    """A parsed module plus its comment-level qdlint annotations."""

    path: pathlib.Path
    rel: str
    tree: ast.Module
    lines: list[str]
    deterministic: bool
    # lineno -> (lock expressions, kind: "guard" | "swap")
    guards: dict[int, tuple[tuple[str, ...], str]]
    # lineno -> marker names on that line (hot-path / holds-lock / jit-body)
    markers: dict[int, set[str]]
    # lineno -> (suppressed codes, reason text)
    suppressions: dict[int, tuple[frozenset, str]]

    def markers_on(self, lineno: int) -> set[str]:
        return self.markers.get(lineno, set())


@dataclasses.dataclass
class FileResult:
    findings: list[Finding]
    suppressed: list[Finding]


@dataclasses.dataclass
class Report:
    """Aggregate result of one qdlint run."""

    findings: list[Finding]  # actionable (not suppressed, not baselined)
    baselined: list[Finding]
    suppressed: list[Finding]
    files: int

    def counts(self) -> dict[str, int]:
        out = {code: 0 for code in CHECKER_CODES}
        for f in self.findings:
            out[f.code] = out.get(f.code, 0) + 1
        return out

    def as_dict(self) -> dict:
        return {
            "version": 1,
            "files": self.files,
            "findings": [f.as_dict() for f in self.findings],
            "baselined": len(self.baselined),
            "suppressed": len(self.suppressed),
            "counts": self.counts(),
        }


def _split_locks(raw: str) -> tuple[str, ...]:
    return tuple(
        lock.strip() for lock in raw.split(",") if lock.strip()
    )


def parse_module(
    path: os.PathLike, rel: Optional[str] = None
) -> ModuleInfo:
    """Parse ``path`` and extract its qdlint comment annotations.

    The AST carries no comments, so annotations are recovered from the
    raw source lines and keyed by 1-based line number; checkers join
    them to AST nodes via ``node.lineno``.
    """
    p = pathlib.Path(path)
    source = p.read_text(encoding="utf-8")
    tree = ast.parse(source, filename=str(p))
    lines = source.splitlines()
    guards: dict[int, tuple[tuple[str, ...], str]] = {}
    markers: dict[int, set[str]] = {}
    suppressions: dict[int, tuple[frozenset, str]] = {}
    deterministic = False
    for lineno, text in enumerate(lines, start=1):
        if "#" not in text:
            continue
        m = _SUPPRESS_RE.search(text)
        if m:
            codes = frozenset(
                c.strip() for c in m.group("codes").split(",")
            )
            suppressions[lineno] = (codes, m.group("reason").strip())
        m = _SWAP_RE.search(text)
        if m:
            guards[lineno] = (_split_locks(m.group("locks")), "swap")
        else:
            m = _GUARD_RE.search(text)
            if m:
                guards[lineno] = (
                    _split_locks(m.group("locks")), "guard"
                )
        for m in _MARKER_RE.finditer(text):
            marker = m.group("marker")
            if marker == "deterministic-module":
                deterministic = True
            else:
                markers.setdefault(lineno, set()).add(marker)
    if rel is None:
        try:
            rel = os.path.relpath(p)
        except ValueError:  # different drive (windows)
            rel = str(p)
    return ModuleInfo(
        path=p,
        rel=pathlib.PurePath(rel).as_posix(),
        tree=tree,
        lines=lines,
        deterministic=deterministic,
        guards=guards,
        markers=markers,
        suppressions=suppressions,
    )


def analyze_file(
    path: os.PathLike, rel: Optional[str] = None
) -> FileResult:
    """Run every checker over one file and apply inline suppressions."""
    # imported here so checker modules can import Finding from core
    from repro_torch.analysis.determinism import check_determinism
    from repro_torch.analysis.lock_check import check_locks
    from repro_torch.analysis.retrace import check_retrace

    info = parse_module(path, rel=rel)
    raw: list[Finding] = []
    raw.extend(check_locks(info))
    raw.extend(check_determinism(info))
    raw.extend(check_retrace(info))
    raw.sort(key=lambda f: (f.line, f.col, f.code, f.message))
    findings: list[Finding] = []
    suppressed: list[Finding] = []
    for f in raw:
        entry = info.suppressions.get(f.line)
        if entry is not None:
            codes, reason = entry
            # a reason is mandatory: an undocumented disable is inert
            if f.code in codes and reason:
                suppressed.append(f)
                continue
        findings.append(f)
    return FileResult(findings=findings, suppressed=suppressed)


def iter_python_files(
    paths: Sequence[os.PathLike],
) -> Iterable[pathlib.Path]:
    """Expand files/directories into the .py files qdlint scans."""
    for raw in paths:
        p = pathlib.Path(raw)
        if p.is_dir():
            # the exclusion only applies to directory expansion: naming
            # a fixture file explicitly (tests, self-test) still scans it
            for c in sorted(p.rglob("*.py")):
                posix = c.as_posix()
                if any(frag in posix for frag in EXCLUDED_FRAGMENTS):
                    continue
                yield c
        else:
            yield p


def load_baseline(path: os.PathLike) -> Counter:
    """The committed fingerprint multiset (empty if the file is absent)."""
    p = pathlib.Path(path)
    if not p.exists():
        return Counter()
    doc = json.loads(p.read_text(encoding="utf-8"))
    return Counter(doc.get("findings", []))


def write_baseline(
    findings: Iterable[Finding], path: os.PathLike
) -> None:
    fps = sorted(f.fingerprint() for f in findings)
    doc = {"version": 1, "findings": fps}
    pathlib.Path(path).write_text(
        json.dumps(doc, indent=2) + "\n", encoding="utf-8"
    )


def run(
    paths: Sequence[os.PathLike],
    baseline: Optional[os.PathLike] = None,
) -> Report:
    """Scan ``paths`` and return a :class:`Report`.

    With ``baseline``, findings whose fingerprints appear in the
    committed multiset are absorbed (each baseline entry absorbs one
    occurrence) and reported under ``baselined`` instead.
    """
    budget = load_baseline(baseline) if baseline is not None else Counter()
    findings: list[Finding] = []
    baselined: list[Finding] = []
    suppressed: list[Finding] = []
    files = 0
    for path in iter_python_files(paths):
        files += 1
        result = analyze_file(path)
        suppressed.extend(result.suppressed)
        for f in result.findings:
            fp = f.fingerprint()
            if budget.get(fp, 0) > 0:
                budget[fp] -= 1
                baselined.append(f)
            else:
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return Report(
        findings=findings,
        baselined=baselined,
        suppressed=suppressed,
        files=files,
    )
