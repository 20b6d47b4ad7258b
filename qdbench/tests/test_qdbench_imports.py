"""No module that a run loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``repro`` (the JAX package); names compare whole, so the
port's ``repro_torch`` passes.  A run of the harness on the CPU, in a
fresh process, then a look at ``sys.modules``; and the harness's sources
import none of them."""

import ast
import pathlib
import subprocess
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_a_run_loads_no_jax_package():
    code = (
        "import sys\n"
        "from qdbench import run\n"
        "r = run.run_cell(run.load_benchmark(), 'tpch-sf100-b600k.bulk', 5,"
        " 0.02, traced=False, device='cpu',"
        " sizes={'resident_rows': 1024, 'batch_rows': 512,"
        " 'pass_rows': 1500})\n"
        "assert r['correct']\n"
        "print(run.forbidden_modules(), 'repro_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=BENCH.parent, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_compare_whole():
    from qdbench import run

    assert run.forbidden_modules(["repro_torch", "repro_torch.core",
                                  "jaxtyping", "flaxen.x", "numpy"]) == []
    assert run.forbidden_modules(["repro.core", "jax._src", "flax",
                                  "jaxlib.xla", "repro_torch"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_sources_import_no_jax_package():
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            assert not {n.split(".")[0] for n in names} & FORBIDDEN, path
