"""The port's ingest and serve command lines against ``repro.launch`` on
the CPU.

Each CLI runs at a tiny size with ``--device cpu`` (the kernels' plain
versions) and, from the same flags and seed, the reference's with
``--backend numpy``.  The deterministic fields of the two JSON summaries
must be equal: blocks, records and batches, the scanned fraction, the
coordinator's folds and the tracker's counts (ingest); served and shed
counts, stale responses and the generation after the mid-run swap
(serve).  No timing is compared.  The port's serve summary must show no
plan build while serving.
"""

import json
import re
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import ingest as tingest  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402


def _run_ref_ingest(monkeypatch, capsys, argv):
    from repro.launch import ingest as ringest

    monkeypatch.setattr(sys, "argv", ["ingest", *argv])
    ringest.main()
    out = capsys.readouterr().out
    return json.loads(out.strip().splitlines()[-1]), out


def _blocks(out, tool):
    return int(re.search(rf"\[{tool}\] built \w+ layout[^(]*\((\d+) blocks"
                         if tool == "ingest" else
                         rf"\[{tool}\] built \w+ layout: (\d+) blocks",
                         out).group(1))


INGEST_ARGV = ["--rows", "12000", "--batch", "1024", "--shards", "2",
               "--coordinator", "--track-workload", "--executor", "thread",
               "--min-block", "300", "--seed", "3"]


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_ingest_cli_summary_matches_repro(monkeypatch, capsys, tmp_path):
    got = tingest.main([*INGEST_ARGV, "--device", "cpu",
                        "--store", str(tmp_path / "port")])
    port_out = capsys.readouterr().out
    assert json.loads(port_out.strip().splitlines()[-1]) == got
    want, ref_out = _run_ref_ingest(
        monkeypatch, capsys,
        [*INGEST_ARGV, "--backend", "numpy",
         "--store", str(tmp_path / "ref")])
    assert got["device"] == "cpu" and got["backend"] == "torch"
    assert got["n_blocks"] == _blocks(port_out, "ingest") == _blocks(
        ref_out, "ingest")
    for key in ("n_records", "n_batches", "scanned_fraction", "n_shards",
                "fused", "coordinator", "workload_tracking", "workload"):
        assert got[key] == want[key], key
    assert got["coordinator"]["folds"] >= 1
    assert got["ingest_builds"] == {}
    # the persisted stores hold the same blocks
    persisted = re.compile(r"persisted (\d+) rows in (\d+) blocks")
    assert persisted.search(port_out).groups() == persisted.search(
        ref_out).groups()


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_ingest_cli_drift_and_rebuild_run_on_cpu(capsys):
    """The drift monitor, tracker and end-of-run rebuild drive the port's
    service; the ingest itself builds no plan."""
    got = tingest.main(["--rows", "8000", "--batch", "512", "--drift",
                        "--track-workload", "--rebuild", "--min-block",
                        "200", "--device", "cpu"])
    capsys.readouterr()
    assert got["n_records"] == 8000
    assert got["drift"]["generation"] >= 1
    assert got["rebuild"]["generation"] == got["drift"]["generation"] + (
        1 if got["rebuild"]["swapped"] else 0)
    assert got["workload_tracking"]["queries_seen"] > 0


SERVE_ARGV = ["--rows", "6000", "--qps", "200", "--duration", "1.5",
              "--min-block", "150", "--workload", "auto", "--seed", "2"]


def test_serve_cli_summary_matches_repro(capsys):
    from repro.launch import serve as rserve

    got = tserve.main([*SERVE_ARGV, "--device", "cpu"])
    port_out = capsys.readouterr().out
    want = rserve.main([*SERVE_ARGV, "--backend", "numpy"])
    ref_out = capsys.readouterr().out
    assert got["device"] == "cpu"
    assert _blocks(port_out, "serve") == _blocks(ref_out, "serve")
    for key in ("qps_target", "served", "rejected", "stale_responses",
                "generation", "workload"):
        assert got[key] == want[key], key
    assert got["stale_responses"] == 0
    assert got["serve_builds"] == {}
    assert got["swap"]["swapped"] == want["swap"]["swapped"]
    assert got["tracker"]["queries_seen"] == want["tracker"]["queries_seen"]
    assert got["counters"]["queries_served"] == got["served"]


def test_clis_default_to_the_gpu_and_take_the_port_backends(capsys):
    argv = ["--rows", "2000", "--min-block", "100"]
    if not torch.cuda.is_available():
        for main in (tingest.main, tserve.main):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                main(argv)
    for main in (tingest.main, tserve.main):
        with pytest.raises(SystemExit):
            main([*argv, "--backend", "jax", "--device", "cpu"])
    assert "invalid choice" in capsys.readouterr().err
