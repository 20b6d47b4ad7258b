"""qdlint for the port (``repro_torch.analysis``): its self-test, a clean
scan of ``src/repro_torch`` against its empty baseline, finding-for-
finding parity with ``repro.analysis`` on the JAX package's fixtures for
the rules the two share (QD001, QD002, QD005 and the suppressions), the
torch forms of QD003 and QD004 on the port's own fixtures, and the JAX
package's scan of ``src`` still clean with the port's fixtures in the
tree.  About 5 s on a CPU host."""

import json
import pathlib

import pytest

from repro.analysis import analyze_file as ref_analyze
from repro.analysis import run as ref_run
from repro_torch.analysis import (
    DEFAULT_BASELINE,
    analyze_file,
    iter_python_files,
    load_baseline,
    main,
    run,
    self_test,
)
from repro_torch.analysis.cli import FIXTURES_DIR

REPO = pathlib.Path(__file__).resolve().parent.parent
REF_FIXTURES = REPO / "src" / "repro" / "analysis" / "fixtures"
SHARED = ("qd001_tp", "qd001_ok", "qd002_tp", "qd002_ok", "qd005_tp",
          "qd005_ok", "suppress_ok", "suppress_noreason")


def _rows(result):
    return [(f.code, f.line, f.col, f.symbol, f.message)
            for f in result.findings], [
        (f.code, f.line, f.col, f.symbol, f.message)
        for f in result.suppressed]


def test_self_test_passes():
    assert self_test(verbose=False)
    assert main(["--self-test"]) == 0


def test_port_sources_are_clean_against_an_empty_baseline(capsys):
    baseline = REPO / DEFAULT_BASELINE
    assert json.loads(baseline.read_text()) == {"version": 1,
                                                "findings": []}
    assert sum(load_baseline(baseline).values()) == 0
    report = run([REPO / "src" / "repro_torch"], baseline=baseline)
    assert report.findings == [], [f.render() for f in report.findings]
    assert report.files > 90
    assert main([str(REPO / "src" / "repro_torch"), "--baseline",
                 str(baseline)]) == 0
    assert "0 finding(s)" in capsys.readouterr().out


@pytest.mark.parametrize("stem", SHARED)
def test_shared_rules_equal_the_reference(stem):
    path = REF_FIXTURES / f"{stem}.py"
    want = _rows(ref_analyze(path))
    assert _rows(analyze_file(path)) == want
    # the port's copy of the fixture gives the same findings
    own = FIXTURES_DIR / f"{stem}.py.txt"
    assert own.read_text() == path.read_text()
    got = analyze_file(own, rel=path.relative_to(REPO).as_posix())
    ref = ref_analyze(path, rel=path.relative_to(REPO).as_posix())
    assert _rows(got) == _rows(ref)


def test_fixtures_stay_out_of_every_directory_scan():
    fixtures = sorted(FIXTURES_DIR.iterdir())
    assert len(fixtures) == 12 and all(f.name.endswith(".py.txt")
                                       for f in fixtures)
    scanned = set(iter_python_files([REPO / "src"]))
    assert not any(p.parent == FIXTURES_DIR for p in scanned)
    report = ref_run([REPO / "src"], baseline=REPO / "qdlint-baseline.json")
    assert report.findings == [], [f.render() for f in report.findings]


def test_recompile_hazards_fire_in_their_torch_forms():
    tp = analyze_file(FIXTURES_DIR / "qd003_tp.py.txt")
    assert {f.code for f in tp.findings} == {"QD003"}
    assert sorted(f.symbol for f in tp.findings) == [
        "bits", "clip", "descend", "route_plan", "scale"]
    assert sum("PlanKey m_bucket" in f.message for f in tp.findings) == 1
    assert analyze_file(FIXTURES_DIR / "qd003_ok.py.txt").findings == []


def test_host_syncs_fire_in_their_torch_forms():
    tp = analyze_file(FIXTURES_DIR / "qd004_tp.py.txt")
    assert {f.code for f in tp.findings} == {"QD004"}
    said = " ".join(f.message for f in tp.findings)
    for call in ("float(...)", ".item()", ".cpu()", ".numpy()", ".tolist()",
                 "torch.cuda.synchronize(...)", "np.asarray(...)",
                 "np.array(...)"):
        assert call in said, call
    assert len(tp.findings) == 8
    assert analyze_file(FIXTURES_DIR / "qd004_ok.py.txt").findings == []


def test_the_port_marks_its_hot_paths_and_deterministic_kernels():
    from repro_torch.analysis.core import parse_module

    src = REPO / "src" / "repro_torch"
    engine = parse_module(src / "engine" / "engine.py")
    hot = sorted(n for n, m in engine.markers.items() if "hot-path" in m)
    assert len(hot) == 4
    for name in ("route_records", "fused_ingest", "query_intersect"):
        assert parse_module(src / "kernels" / f"{name}.py").deterministic
