"""qdlint for the PyTorch port: invariant-aware static analysis.

Stdlib-only on purpose, and it imports nothing of the package it scans:
``PYTHONPATH=src python -m repro_torch.analysis src/repro_torch
--baseline qdlint-torch-baseline.json`` runs with nothing else installed.
See :mod:`repro_torch.analysis.core` for the rule catalogue and
annotation conventions.
"""

from repro_torch.analysis.core import (
    CHECKER_CODES,
    EXCLUDED_FRAGMENTS,
    FileResult,
    Finding,
    ModuleInfo,
    Report,
    analyze_file,
    iter_python_files,
    load_baseline,
    parse_module,
    run,
    write_baseline,
)
from repro_torch.analysis.cli import DEFAULT_BASELINE, main, self_test

__all__ = [
    "CHECKER_CODES",
    "DEFAULT_BASELINE",
    "EXCLUDED_FRAGMENTS",
    "FileResult",
    "Finding",
    "ModuleInfo",
    "Report",
    "analyze_file",
    "iter_python_files",
    "load_baseline",
    "main",
    "parse_module",
    "run",
    "self_test",
    "write_baseline",
]
