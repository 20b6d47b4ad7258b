"""The dynamic half of qdlint's QD002 on the port: sections 1–4 of the
hash-seed probe (the plan counters' delta, the k-way ``TrackerState``
merge and inference, replica ``signature_features`` and the k-way
``ShardState`` merge) run through ``repro_torch`` in subprocesses under
two ``PYTHONHASHSEED`` values, and the digests equal each other and the
JAX package's over the same sections (``tests/_torch_hash_seed_probe.py``;
section 5 runs in ``test_torch_coordinator.py``).  About 10 s on a CPU
host: three subprocesses."""

import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

PROBE = pathlib.Path(__file__).resolve().parent / "_torch_hash_seed_probe.py"
SRC = pathlib.Path(__file__).resolve().parent.parent / "src"


def _digest(pkg: str, seed: int) -> str:
    env = {**os.environ, "PYTHONPATH": str(SRC),
           "PYTHONHASHSEED": str(seed), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, str(PROBE), pkg], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    digest = proc.stdout.strip().splitlines()[-1]
    assert len(digest) == 64, digest
    return digest


def test_port_merges_are_hash_seed_independent_and_equal_the_reference():
    digests = {seed: _digest("repro_torch", seed) for seed in (0, 1)}
    assert len(set(digests.values())) == 1, digests
    assert digests[0] == _digest("repro", 1)
