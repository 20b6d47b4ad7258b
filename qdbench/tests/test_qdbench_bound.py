"""The fold's frozen bound against a count by hand."""

import numpy as np

from qdbench import bound, layout


def test_bytes_of_a_batch_by_hand():
    arrays = layout.load(layout.load_config("tpch-sf100-b600k"))
    m = 1 << 20
    records = m * 21 * 4
    nodes = 1447 * 4 * 4  # cut, left, right, block id: int32 each
    cuts = 379 * 4 * 4 + 379 * 19  # kind, column, point, adv id; 146 bits
    adv = 3 * 3 * 4
    # a leaf: its count, 21 minima and maxima, 146 categorical bits in 5
    # words and 3 x 2 advanced-cut bits in 1, read and written once
    accumulators = 2 * 724 * (8 + 4 * (2 * 21 + 5 + 1))
    assert bound.fold_bytes(arrays, m) == (records + nodes + cuts + adv
                                           + accumulators)


def test_seconds_bound_by_bytes_and_operations():
    arrays = layout.load(layout.load_config("tpch-sf100-b600k"))
    leaves = 724
    counts = np.zeros(leaves, np.int64)
    counts[:4] = 1 << 20  # four batches' rows in four leaves
    depth = layout.leaf_depths(arrays)[:4]
    ops = int((depth << 20).sum()) + 4 * (1 << 20) * (2 * 21 + 11 + 3 + 1)
    assert bound.fold_ops(arrays, counts) == ops
    got = bound.fold_seconds(arrays, counts, batches=4)
    t_bytes = bound.fold_bytes(arrays, 1 << 20) / 3.35e12
    assert got["by"] == "bytes"
    assert abs(got["seconds"] - t_bytes) < 1e-15
    assert ops / 4 / 67e12 < t_bytes


def test_uneven_batches_count_each_batch_once():
    arrays = layout.load(layout.load_config("tpch-sf1000-b600k"))
    counts = np.zeros(7211, np.int64)
    counts[5] = 3 * (1 << 20) + 777  # three whole batches and a short one
    got = bound.fold_seconds(arrays, counts, batches=4)["seconds"]
    by_batch = sum(bound.fold_bytes(arrays, m)
                   for m in (1 << 20, 1 << 20, 1 << 20, 777))
    assert abs(got * 4 - by_batch / 3.35e12) < 1e-15
