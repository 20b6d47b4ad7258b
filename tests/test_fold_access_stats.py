"""``tools/fold_access_stats.py``: its model of ``fused_ingest_shared``'s
shared atomics against a row-by-row count, its sorted window against the
benchmark's sorted table, and the seeded start on a batch folded again."""

import importlib.util
import json
import math
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qdbench import datagen, reference  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _tool():
    spec = importlib.util.spec_from_file_location(
        "fold_access_stats", ROOT / "tools" / "fold_access_stats.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


fas = _tool()


@pytest.fixture(scope="module")
def small():
    """A 40-leaf tree grown over the tpch workload's cuts, as a layout
    file's arrays, and 3,000 of the benchmark's rows."""
    from repro_torch.core.qdtree import random_layout
    from repro_torch.data.datagen import make_tpch_like
    from repro_torch.data.workload import make_tpch_workload

    schema, sample = make_tpch_like(160, seed=0)
    work, _ = make_tpch_workload(schema, n_per_template=10, seed=0)
    frozen = random_layout(work.candidate_cuts(), sample, 40, 0)
    ref = reference.Layout(frozen.to_arrays(), "cpu")
    return ref, datagen.generate(3000, 11, "cpu")


def test_a_batch_folded_again_makes_no_atomics_from_seeded_starts(small):
    ref, rows = small
    first, again = fas.batch_stats(ref, [rows, rows], warps=4, sms=8)
    # a pass's first batch starts from identities either way
    assert first["seeded"] == first["identity"]
    assert first["identity"]["total"] > 0
    assert again["identity"] == first["identity"]
    assert again["seeded"] == {"minmax": 0.0, "cat": 0.0, "adv": 0.0,
                               "total": 0.0}
    assert again["merged_pairs"] == 0 < first["merged_pairs"]


def _one_row_at_a_time(ref, rows, leaf, block, start):
    """The atomics of each (block, leaf)'s rows in row order, and the
    pairs where one ran: a plain loop over the rows."""
    state, n, moved = {}, {"minmax": 0, "cat": 0, "adv": 0}, set()
    for r in range(rows.shape[0]):
        lf, key = int(leaf[r]), (int(block[r]), int(leaf[r]))
        if key not in state:
            seen = int(start.counts[lf]) > 0
            state[key] = {
                "lo": [int(start.lo[lf, j]) if seen else math.inf
                       for j in range(ref.ndims)],
                "hi": [int(start.hi[lf, j]) - 1 if seen else -math.inf
                       for j in range(ref.ndims)],
                "bits": {("cat", b) for b in range(ref.bits)
                         if bool(start.cat[lf, b])}
                | {("adv", j, s) for j in range(len(ref.adv))
                   for s in (0, 1) if bool(start.adv[lf, j, s])},
            }
        st = state[key]
        v = [int(x) for x in rows[r]]
        for j, x in enumerate(v):
            for side, beats in (("lo", x < st["lo"][j]),
                                ("hi", x > st["hi"][j])):
                if beats:
                    st[side][j] = x
                    n["minmax"] += 1
                    moved.add(key)
        words = [("cat", "cat", min(int(ref.cat_off[c]) + v[c], ref.bits - 1))
                 for c in ref.cat_dims]
        words += [("adv", "adv", j, int(not reference.OPS[op](
            torch.tensor(v[a]), torch.tensor(v[b]))))
            for j, (a, op, b) in enumerate(ref.adv)]
        for kind, *bit in words:
            if tuple(bit) not in st["bits"]:
                st["bits"].add(tuple(bit))
                n[kind] += 1
                moved.add(key)
    return n, len(state), len(moved)


@pytest.mark.parametrize("seeded", [False, True])
def test_shared_atomics_count_each_row_in_order(small, seeded):
    ref, rows = small
    rows = rows[:700]
    leaf = ref.route(rows)
    block = fas.tile_blocks(rows.shape[0], 2, 5)
    start = reference.Fold.empty(ref)
    if seeded:  # the running aggregates of 2,000 other rows
        other = datagen.generate(2000, 12, "cpu")
        start.add(ref, other, ref.route(other))
    got = fas.shared_atomics(ref, rows, leaf, block, start)
    want, pairs, moved = _one_row_at_a_time(ref, rows, leaf, block, start)
    m = rows.shape[0]
    assert {k: round(got[k] * m) for k in want} == want
    assert (got["pairs"], got["merged_pairs"]) == (pairs, moved)
    # the tiles: distinct leaves, and the most of them in one bank
    tiles = fas.tile_stats(leaf, ref.n_leaves, ref.ndims)
    per_tile = [leaf[s:s + 32].unique() for s in range(0, m, 32)]
    assert tiles["leaves_a_tile"] == pytest.approx(
        np.mean([t.numel() for t in per_tile]))
    assert tiles["wavefronts"] == pytest.approx(np.mean([
        np.bincount((t * ref.ndims % 32).numpy(), minlength=32).max()
        for t in per_tile[:m // 32]]))


def test_sorted_window_is_the_sorted_tables_rows(monkeypatch):
    monkeypatch.setattr(datagen, "CHUNK", 1000)  # several chunks
    table = datagen.generate_sorted(3500, 2**33 + 5, "cpu", 0)
    got = fas.sorted_window(3500, 2**33 + 5, 0, 1200, 900)
    assert torch.equal(got, table[1200:2100])


def test_main_prints_each_batch(capsys):
    assert fas.main(["--batches", "2", "--batch-rows", "4096"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    stats = json.loads(out[-1])
    assert [b["rank"] for b in stats["batches"]] == [0, 1]
    assert stats["warps"] == 32  # the plan's, at 724 leaves
    assert sum(line.startswith("| ") for line in out) == 3
