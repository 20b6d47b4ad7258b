"""The frozen generator: the same seed gives the same rows, every column
stays in its domain, and the dates keep TPC-H's correlations."""

import numpy as np
import pytest
import torch

from qdbench import datagen


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**33 + 1, -3])
def test_same_seed_same_rows(seed):
    a = datagen.generate(5000, seed, "cpu")
    b = datagen.generate(5000, seed, "cpu")
    assert a.dtype == torch.int32 and a.shape == (5000, datagen.NDIMS)
    assert torch.equal(a, b)
    assert not torch.equal(a, datagen.generate(5000, seed + 1, "cpu"))


def test_columns_in_domain_and_correlated():
    rows = datagen.generate(20000, 11, "cpu").numpy().astype(np.int64)
    doms = np.array([dom for _, _, dom in datagen.schema_columns()])
    assert (rows >= 0).all() and (rows < doms).all()
    ship, commit, receipt, order = rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 6]
    assert ship.max() < datagen.SHIP_DAYS
    assert ((receipt - ship >= 1) & (receipt - ship <= 30)).all()
    assert ((commit - ship >= -30) & (commit - ship <= 59)).all()
    assert ((ship - order >= 0) & (ship - order <= 120)).all()
    # both polarities of the advanced cuts are present
    assert 0 < (commit < receipt).mean() < 1
    assert 0 < (ship < commit).mean() < 1


def test_schema_is_the_programs():
    from repro_torch.data.datagen import tpch_like_schema

    assert [(c.name, c.kind, c.dom) for c in tpch_like_schema().columns] == \
        datagen.schema_columns()


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_chunks_draw_alone_and_chunk_zero_is_the_seeds(seed, monkeypatch):
    monkeypatch.setattr(datagen, "CHUNK", 1000)
    rows = datagen.generate(3500, seed, "cpu")
    for c, s, e in datagen.chunks(3500):
        assert torch.equal(rows[s:e],
                           datagen.draw_chunk(e - s, seed, c, "cpu").t())
    # chunk 0 is one generator seeded with the seed, the layouts' sample
    gen = torch.Generator().manual_seed(seed % 2**64)
    first = torch.randint(0, datagen.SHIP_DAYS, (1000,), generator=gen,
                          dtype=torch.int32)
    assert torch.equal(rows[:1000, 0], first)
    assert not torch.equal(rows[:1000], rows[1000:2000])


@pytest.mark.parametrize("column", [0, 12])
def test_generate_sorted_is_a_stable_sort(column, monkeypatch):
    monkeypatch.setattr(datagen, "CHUNK", 700)
    rows = datagen.generate(2500, 9, "cpu")
    order = torch.sort(rows[:, column], stable=True).indices
    assert torch.equal(datagen.generate_sorted(2500, 9, "cpu", column),
                       rows.index_select(0, order))
