"""The table of peaks and the fold's least time, counted from the layout
file and the rows, whatever implements the fold.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
3.35e12 B/s of HBM and 67e12 scalar operations a second outside the
tensor cores.

A fold of ``m`` rows of ``d`` int32 columns (route and tighten, no block
ids out) reads the rows once, the layout's nodes and cut table once, and
reads and writes each leaf's aggregates once: its row count (8 B), its
minimum and maximum of each column (4 B each: every domain is below
2**31), its categorical bits and its two bits per advanced cut, in 32-bit
words.  Its operations: one per cut on each row's root path, and per row
one per aggregate it folds (2 d, one per categorical column, one per
advanced cut, and the count).  The least time is the larger of bytes over
the bandwidth and operations over the scalar rate.
"""

from __future__ import annotations

import json

import numpy as np

from qdbench.layout import leaf_depths

PEAKS = {"hbm_bytes_per_s": 3.35e12, "scalar_ops_per_s": 67e12}
NODE_KEYS = ("cut_id", "left", "right", "leaf_bid")
CUT_KEYS = ("ct_kind", "ct_dim", "ct_cutpoint", "ct_adv_id")


def words(bits: int) -> int:
    return -(-bits // 32)


def table_bytes(arrays: dict) -> int:
    """The layout's nodes and cut table: each node's cut, children and
    block id; each cut's kind, column, cut point and advanced id, its
    categorical set as bits; each advanced cut's two columns and op."""
    nodes = sum(np.asarray(arrays[k]).nbytes for k in NODE_KEYS)
    cuts = sum(np.asarray(arrays[k]).nbytes for k in CUT_KEYS)
    n_cuts, bits = np.asarray(arrays["ct_in_mask"]).shape
    return (nodes + cuts + n_cuts * -(-bits // 8)
            + np.asarray(arrays["ct_adv"]).nbytes)


def shape(arrays: dict) -> dict:
    cols = json.loads(str(arrays["schema"]))
    n_cat = sum(kind == "categorical" for _, kind, _ in cols)
    bits = sum(int(dom) for _, kind, dom in cols if kind == "categorical")
    return {"leaves": int(np.asarray(arrays["leaf_lo"]).shape[0]),
            "d": len(cols), "n_cat": n_cat, "bits": bits,
            "n_adv": int(np.asarray(arrays["ct_adv"]).reshape(-1, 3).shape[0])}


def fold_bytes(arrays: dict, m: int) -> int:
    s = shape(arrays)
    leaf = 8 + 4 * (2 * s["d"] + words(s["bits"]) + words(2 * s["n_adv"]))
    return m * s["d"] * 4 + table_bytes(arrays) + 2 * s["leaves"] * leaf


def fold_ops(arrays: dict, counts: np.ndarray) -> int:
    """Operations of a fold of rows that the layout sends ``counts[l]`` to
    leaf ``l``."""
    s = shape(arrays)
    m = int(counts.sum())
    path = int((leaf_depths(arrays) * counts).sum())
    return path + m * (2 * s["d"] + s["n_cat"] + s["n_adv"] + 1)


def fold_seconds(arrays: dict, counts: np.ndarray, batches: int) -> dict:
    """The least time of a batch, on average over ``batches`` batches whose
    rows go ``counts`` to the leaves altogether; and what bounds it."""
    m = int(counts.sum())
    t_bytes = (batches * fold_bytes(arrays, 0) + m * shape(arrays)["d"] * 4
               ) / PEAKS["hbm_bytes_per_s"]
    t_ops = fold_ops(arrays, counts) / PEAKS["scalar_ops_per_s"]
    by = "bytes" if t_bytes >= t_ops else "operations"
    return {"seconds": max(t_bytes, t_ops) / batches, "by": by}
