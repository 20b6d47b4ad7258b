"""The port's examples (``examples_torch/``) on the CPU: each of the five
runs with ``--device cpu`` at a reduced size and exits 0, and the
quickstart's scanned fractions of the range and greedy layouts and the
selectivity lower bound equal the JAX package's at the same size and
seed, with ``==`` (the layout path is bit-identical; WOODBLOCK's agent
is not, its update being float arithmetic on another framework).  About
40 s on a CPU host: one subprocess an example, two for the restart."""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _smoke_examples() -> dict:
    """Each example's reduced size: ``chip_smoke.EXAMPLES``, the table the
    smoke runs them at on the card (the module imports only the standard
    library and numpy at load)."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_sizes", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.EXAMPLES


EXAMPLES = _smoke_examples()
QUICKSTART = EXAMPLES["quickstart.py"]


def _run(name: str, args) -> str:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples_torch" / name),
         "--device", "cpu", *args],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"{name[:-3]} OK" in proc.stdout, proc.stdout[-2000:]
    return proc.stdout


@pytest.mark.parametrize("name", sorted(set(EXAMPLES) - {"quickstart.py"}))
def test_example_runs_on_the_cpu(name):
    _run(name, EXAMPLES[name])


def test_quickstart_equals_the_reference():
    out = _run("quickstart.py", QUICKSTART)
    got = json.loads(out.strip().splitlines()[-2])

    from repro.core import rewards
    from repro.data import datagen, workload as wl
    from repro.service import build_layout

    size = {k[2:]: int(v) for k, v in zip(QUICKSTART[::2], QUICKSTART[1::2])}
    schema, records = datagen.make_errorlog_int(size["rows"], seed=0)
    work, _ = wl.make_errorlog_int_workload(schema,
                                            n_queries=size["queries"], seed=0)
    cuts = work.candidate_cuts()
    for strategy, cfg in (("range", dict(column=0)), ("greedy", {})):
        ref = build_layout(records, work, strategy=strategy, cuts=cuts,
                           min_block=size["min-block"], **cfg)
        assert got["scanned"][strategy] == ref.scanned_fraction, strategy
    assert got["lower_bound"] == rewards.selectivity_lower_bound(records,
                                                                 work)
    assert 0 < got["scanned"]["woodblock"] <= 1
