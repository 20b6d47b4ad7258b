"""A run of each cell on the CPU, at a small size, with the timed path
sound and then broken underneath: ``correct`` has to come out true, and
false for the control and for each fault the cell can have (no cell runs
across chips, so none can leave an exchange between chips out).  A pass
sends the resident rows twice and then part of a batch, as the cells'
passes cycle the resident rows and cut their last batch."""

import pytest

from qdbench import faults, run

SIZES = {"resident_rows": 2 * 1024, "batch_rows": 1024, "pass_rows": 5000}
CELLS = [w["name"] for w in run.load_benchmark()["workloads"]]


def one_run(cell, fault):
    return run.run_cell(run.load_benchmark(), cell, 2**31 + 17, 0.02,
                        traced=False, device="cpu", sizes=SIZES, fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = one_run(cell, None)
    assert result["correct"], result["checks"]
    assert all(c["value"] == 0 for c in result["checks"].values())
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"setup_s", "ingest_rows_per_s"}
    assert result["attempted"] % 5 == 0  # whole passes of five batches


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(cell, fault):
    result = one_run(cell, fault)
    assert not result["correct"], (fault, result["checks"])
