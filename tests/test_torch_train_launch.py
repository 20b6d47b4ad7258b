"""The port's training CLI (``repro_torch.launch.train``) on the CPU.

Its data tier (errorlog table, greedy qd-tree, block store, curated
pipeline) is held to ``repro.launch.train``'s on the same seed: the same
blocks, the same blocks skipped by the curation query and the same first
batches, exactly.  Then the CLI runs at a tiny size, crashes at a chosen
step, and resumes from its last checkpoint: the resumed steps' losses
equal an uninterrupted run's bit for bit (one CPU process, the same
batches: the resume skips the batches the restored steps consumed).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import train as jtrain  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

ROWS, BATCH, SEQ, VOCAB = 20_000, 4, 64, 256
ARGS = ["--device", "cpu", "--rows", str(ROWS), "--steps", "6", "--batch",
        str(BATCH), "--seq", str(SEQ)]


def summary(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("curated", [True, False])
def test_data_tier_equals_the_reference(tmp_path, curated):
    js, jstore = jtrain.build_data_tier(str(tmp_path / "j"), ROWS, 2_000)
    ts, tstore = ttrain.build_data_tier(str(tmp_path / "t"), ROWS, 2_000,
                                        device="cpu")
    assert [c.name for c in ts.columns] == [c.name for c in js.columns]
    assert tstore.tree.n_leaves == jstore.tree.n_leaves
    assert np.array_equal(tstore.sizes, jstore.sizes)
    jb = jtrain.batches_from_pipeline(jstore, js, BATCH, SEQ, VOCAB, curated)
    tb = ttrain.batches_from_pipeline(tstore, ts, BATCH, SEQ, VOCAB, curated,
                                      device="cpu")
    for _ in range(3):
        want, got = next(jb), next(tb)
        for k in ("tokens", "labels"):
            assert got[k].device.type == "cpu"
            assert np.array_equal(got[k].numpy(), np.asarray(want[k]))


def test_curation_skips_the_reference_blocks(tmp_path, capsys):
    js, jstore = jtrain.build_data_tier(str(tmp_path / "j"), ROWS, 2_000)
    jtrain.batches_from_pipeline(jstore, js, BATCH, SEQ, VOCAB, True)
    want = capsys.readouterr().out.strip().splitlines()[-1]
    ts, tstore = ttrain.build_data_tier(str(tmp_path / "t"), ROWS, 2_000,
                                        device="cpu")
    ttrain.batches_from_pipeline(tstore, ts, BATCH, SEQ, VOCAB, True,
                                 device="cpu")
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want and "skipped by the curation query" in got
    assert int(got.split(", ")[1].split()[0]) > 0


def test_cli_crash_and_resume(tmp_path, capsys):
    ttrain.main(ARGS)
    whole = summary(capsys)
    assert whole["device"] == "cpu" and whole["start"] == 0
    assert whole["steps"] == list(range(6))
    assert all(np.isfinite(whole["losses"]))
    assert whole["blocks"] > whole["blocks_skipped"] > 0
    assert whole["launches"]["fused_ingest_shared"] == 0  # plain on the CPU
    assert whole["peak_gb"] is None

    ckpt = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    with pytest.raises(RuntimeError, match="injected failure at step 4"):
        ttrain.main(ARGS + ckpt + ["--fail-at", "4"])
    capsys.readouterr()
    history = ttrain.main(ARGS + ckpt)
    resumed = summary(capsys)
    assert [h["step"] for h in history] == [4, 5]
    assert resumed["start"] == 4 and resumed["steps"] == [4, 5]
    assert resumed["losses"] == whole["losses"][4:]
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_2", "step_4", "step_6"]


def test_cli_refuses_a_mesh_and_a_missing_gpu():
    for flag in ("--data", "--model-par"):
        with pytest.raises(SystemExit):
            ttrain.main(ARGS + [flag, "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.main(["--steps", "1"])
