import pytest

from repro.core import greedy
from repro.data import datagen
from repro.data import workload as wl


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test (multi-device sharding sweeps)"
    )
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the kernels have no CPU mode)"
    )


@pytest.fixture(scope="session")
def tpch_small():
    schema, records = datagen.make_tpch_like(8_000, seed=0)
    work, labels = wl.make_tpch_workload(schema, n_per_template=2, seed=0)
    cuts = work.candidate_cuts(max_adv=4)
    return schema, records, work, cuts


@pytest.fixture(scope="session")
def tpch_tree(tpch_small):
    schema, records, work, cuts = tpch_small
    tree = greedy.build_greedy(
        records, work, cuts, greedy.GreedyConfig(min_block=250)
    )
    frozen = tree.freeze()
    bids = frozen.route(records)
    frozen.tighten(records, bids)
    return frozen, bids


@pytest.fixture(scope="session")
def errorlog_small():
    schema, records = datagen.make_errorlog_int(6_000, seed=1)
    work, _ = wl.make_errorlog_int_workload(schema, n_queries=60, seed=1)
    cuts = work.candidate_cuts()
    return schema, records, work, cuts
