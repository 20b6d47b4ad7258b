"""On the card: a small run of each cell is correct, and its control is
not.  Marked ``gpu``; the full-size control runs are
``python3 qdbench/run.py --workload <cell> --seed <n> --seconds 1
--trace 0 --fault control``."""

import pytest
import torch

from qdbench import run

pytestmark = pytest.mark.gpu
CELLS = [w["name"] for w in run.load_benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_card_run_and_control(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    sizes = {"resident_rows": 8 * (1 << 16), "batch_rows": 1 << 16,
             "pass_rows": 17 * (1 << 16) + 12345}
    for fault, want in ((None, True), ("control", False)):
        result = run.run_cell(run.load_benchmark(), cell, 2**32 + 3, 0.2,
                              traced=False, device="cuda", sizes=sizes,
                              fault=fault)
        assert result["correct"] is want, (fault, result["checks"])
