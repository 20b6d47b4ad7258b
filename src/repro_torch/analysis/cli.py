"""qdlint command line.

    PYTHONPATH=src python -m repro_torch.analysis [paths] [options]

Exit codes: 0 clean (or everything baselined/suppressed), 1 actionable
findings, 2 usage / internal error.

``--self-test`` runs the bundled fixture corpus through every checker
and asserts each rule still fires on its true-positive fixture and
stays silent on its idiomatic twin — a meta-test (``tests/
test_torch_analysis.py``) so a refactor of qdlint itself cannot quietly
stop enforcing a contract.  The fixtures are ``*.py.txt`` files, named
here one by one: no directory scan of ``src`` picks them up.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Optional, Sequence

from repro_torch.analysis.core import (
    CHECKER_CODES,
    Report,
    analyze_file,
    run,
    write_baseline,
)

DEFAULT_BASELINE = "qdlint-torch-baseline.json"
FIXTURES_DIR = pathlib.Path(__file__).resolve().parent / "fixtures"


def _render_text(report: Report) -> str:
    lines = [f.render() for f in report.findings]
    counts = report.counts()
    summary = ", ".join(
        f"{code}={n}" for code, n in counts.items() if n
    ) or "clean"
    lines.append(
        f"qdlint: {len(report.findings)} finding(s) [{summary}] across "
        f"{report.files} file(s); {len(report.baselined)} baselined, "
        f"{len(report.suppressed)} suppressed"
    )
    return "\n".join(lines)


def self_test(verbose: bool = True) -> bool:
    """Assert the fixture corpus still flags/passes per checker."""
    ok = True

    def expect(name: str, codes: set, min_findings: int,
               max_findings: Optional[int] = None,
               min_suppressed: int = 0) -> None:
        nonlocal ok
        path = FIXTURES_DIR / f"{name}.txt"
        result = analyze_file(path)
        got_codes = {f.code for f in result.findings}
        n = len(result.findings)
        good = (
            n >= min_findings
            and (max_findings is None or n <= max_findings)
            and got_codes <= codes
            and (min_findings == 0 or got_codes == codes)
            and len(result.suppressed) >= min_suppressed
        )
        if not good:
            ok = False
        if verbose or not good:
            status = "ok" if good else "FAIL"
            detail = "; ".join(f.render() for f in result.findings)
            print(
                f"[qdlint self-test] {status} {name}: {n} finding(s) "
                f"{sorted(got_codes)} suppressed="
                f"{len(result.suppressed)}"
                + (f" :: {detail}" if not good and detail else "")
            )

    for code in CHECKER_CODES:
        stem = code.lower()
        expect(f"{stem}_tp.py", {code}, min_findings=1)
        expect(f"{stem}_ok.py", set(), min_findings=0, max_findings=0)
    expect("suppress_ok.py", set(), min_findings=0, max_findings=0,
           min_suppressed=1)
    expect("suppress_noreason.py", {"QD001"}, min_findings=1)
    if verbose:
        print(
            "[qdlint self-test] PASS"
            if ok else "[qdlint self-test] FAIL"
        )
    return ok


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="qdlint: invariant-aware static analysis "
        "(lock, determinism, retrace, host-sync, CAS contracts)",
    )
    ap.add_argument(
        "paths", nargs="*",
        help="files or directories to scan (default: src/repro_torch)",
    )
    ap.add_argument(
        "--format", choices=("text", "json"), default="text",
        dest="fmt", help="stdout report format",
    )
    ap.add_argument(
        "--baseline", nargs="?", const=DEFAULT_BASELINE, default=None,
        metavar="PATH",
        help="absorb findings fingerprinted in PATH "
        f"(default when flag given: {DEFAULT_BASELINE})",
    )
    ap.add_argument(
        "--write-baseline", action="store_true",
        help="rewrite the baseline file from the current findings "
        "and exit 0",
    )
    ap.add_argument(
        "--output", metavar="PATH",
        help="also write the JSON report to PATH",
    )
    ap.add_argument(
        "--self-test", action="store_true",
        help="run the bundled fixture corpus through every checker",
    )
    args = ap.parse_args(argv)

    if args.self_test:
        return 0 if self_test() else 1

    paths = args.paths or ["src/repro_torch"]
    missing = [p for p in paths if not pathlib.Path(p).exists()]
    if missing:
        print(f"qdlint: no such path(s): {', '.join(missing)}",
              file=sys.stderr)
        return 2

    if args.write_baseline:
        baseline_path = args.baseline or DEFAULT_BASELINE
        report = run(paths, baseline=None)
        write_baseline(report.findings, baseline_path)
        print(
            f"qdlint: wrote {len(report.findings)} fingerprint(s) to "
            f"{baseline_path}"
        )
        return 0

    report = run(paths, baseline=args.baseline)
    doc = report.as_dict()
    if args.output:
        pathlib.Path(args.output).write_text(
            json.dumps(doc, indent=2) + "\n", encoding="utf-8"
        )
    if args.fmt == "json":
        print(json.dumps(doc, indent=2))
    else:
        print(_render_text(report))
    return 1 if report.findings else 0
