"""The plain reference against the program's numpy backend (the host
route and ``IncrementalTightener``) at a small size, on both layouts."""

import numpy as np
import pytest
import torch

from qdbench import datagen, layout, reference


@pytest.mark.parametrize("name,seed", [("tpch-sf100-b600k", 1),
                                       ("tpch-sf1000-b600k", 2**32 + 9)])
def test_reference_equals_numpy_backend(name, seed, monkeypatch):
    from repro_torch.core.qdtree import FrozenQdTree, IncrementalTightener

    monkeypatch.setattr(reference, "BLOCK_ROWS", 3000)  # several blocks
    arrays = layout.load(layout.load_config(name))
    rows = datagen.generate(8000, seed, "cpu")
    ref = reference.Layout(arrays, "cpu")
    head, tail, touched = reference.route_and_fold(ref, rows, 5000, 1000)
    fold = head.merged(tail)

    tree = FrozenQdTree.from_arrays(arrays)
    host = rows.numpy()
    want_bids = tree.route(host)
    np.testing.assert_array_equal(ref.route(rows).numpy(), want_bids)
    np.testing.assert_array_equal(
        head.counts.numpy(), np.bincount(want_bids[:5000],
                                         minlength=tree.n_leaves))
    np.testing.assert_array_equal(
        touched.numpy(), [len(np.unique(want_bids[s:s + 1000]))
                          for s in range(0, 8000, 1000)])
    t = IncrementalTightener(tree)
    t.update(host, want_bids)
    for k in ("counts", "lo", "hi", "cat", "adv"):
        np.testing.assert_array_equal(getattr(fold, k).numpy(), getattr(t, k))
    t.apply()
    for k, v in fold.described().items():
        np.testing.assert_array_equal(
            v.numpy().astype(np.int64), getattr(tree, k).astype(np.int64))


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys, qdbench.reference, qdbench.check, qdbench.bound; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro', 'repro_torch', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=layout.BENCH.parent)
    assert out.stdout.strip() == "[]"


def test_fold_merges_blocks_like_one():
    arrays = layout.load(layout.load_config("tpch-sf100-b600k"))
    ref = reference.Layout(arrays, "cpu")
    rows = datagen.generate(4000, 3, "cpu")
    whole = reference.Fold.empty(ref)
    whole.add(ref, rows, ref.route(rows))
    parts = reference.Fold.empty(ref)
    for block in rows.split(1500):
        parts.add(ref, block, ref.route(block))
    for k in ("counts", "lo", "hi", "cat", "adv"):
        assert torch.equal(getattr(whole, k), getattr(parts, k))


def test_a_pass_counts_the_cycles_and_the_head():
    from qdbench import check

    arrays = layout.load(layout.load_config("tpch-sf100-b600k"))
    ref = reference.Layout(arrays, "cpu")
    rows = datagen.generate(3000, 4, "cpu")
    head, tail, _ = reference.route_and_fold(ref, rows, 700, 500)
    # a pass of 2 * 3000 + 700 rows, and one shorter than the resident rows
    counts, fold = check.expected(head, tail, 6700, 3000)
    sent = torch.cat([rows, rows, rows[:700]])
    assert (counts == torch.bincount(ref.route(sent), minlength=724).numpy()
            ).all()
    whole = reference.Fold.empty(ref)
    whole.add(ref, sent, ref.route(sent))
    for k in ("lo", "hi", "cat", "adv"):
        assert torch.equal(getattr(fold, k), getattr(whole, k))
    counts, fold = check.expected(head, tail, 700, 3000)
    assert (counts == head.counts.numpy()).all() and fold is head
