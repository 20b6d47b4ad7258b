"""The comparison that decides ``correct``: the program's outputs against
the plain reference's (``qdbench/reference``), exactly.

Every number is a count of things that differ, and every limit is 0: the
layout path is exact (the configuration's ``guarantees``), so one leaf or
one row out of place is a wrong answer.

* ``rows_gap``: over every pass of the window, the most rows by which what
  the entry reports it folded differs from the rows sent;
* ``count_leaves``: over every pass, the most leaves whose row count
  differs from the reference's (route, through the fold's counts);
* ``desc_leaves``: at a pass drawn from the seed and at the last one, the
  most leaves whose description (minimum, maximum + 1, categorical values,
  advanced-cut truths) differs from the reference's fold of the same rows.

A pass sends the resident rows ``cycles`` times over and then their first
``head`` rows again (``stream.pass_batches``); the reference folds the
head and the rest apart, so a pass's counts are ``cycles`` times both
folds' plus the head's, and its descriptions those of every row it sent
(min, max and or do not count repeats).
"""

from __future__ import annotations

import numpy as np
import torch

LIMITS = {"rows_gap": 0, "count_leaves": 0, "desc_leaves": 0}
DESC_KEYS = ("leaf_lo", "leaf_hi", "leaf_cat", "leaf_adv")


def description(tree) -> dict:
    """A copy of the tree's leaf descriptions as the program left them."""
    return {k: np.array(getattr(tree, k)) for k in DESC_KEYS}


def desc_leaves(got: dict, want: dict) -> int:
    """Leaves whose description differs."""
    bad = None
    for k in DESC_KEYS:
        g = torch.as_tensor(got[k]).to(torch.int64)
        w = want[k].cpu().to(torch.int64)
        if g.shape != w.shape:
            return int(w.shape[0])
        diff = (g != w).reshape(g.shape[0], -1).any(dim=1)
        bad = diff if bad is None else bad | diff
    return int(bad.sum())


def expected(head, tail, pass_rows: int, resident_rows: int):
    """A pass's per-leaf counts (numpy) and the reference's fold of every
    row it sends, from the folds of the head rows and of the rest."""
    cycles = pass_rows // resident_rows
    whole = head.merged(tail)
    counts = (cycles * whole.counts + head.counts).cpu().numpy()
    return counts, (whole if cycles else head)


def fold_numbers(passes: list, rows_sent: int, kept: list,
                 ref_counts: np.ndarray, ref_fold) -> dict:
    """``rows_gap``, ``count_leaves`` and ``desc_leaves``; ``passes`` holds
    each pass's ``rows`` and ``counts``, ``kept`` the descriptions kept."""
    want = ref_fold.described()
    rows_gap = max(abs(int(p["rows"]) - rows_sent) for p in passes)
    count_leaves = max(
        int(ref_counts.shape[0]) if p["counts"].shape != ref_counts.shape
        else int((p["counts"] != ref_counts).sum())
        for p in passes)
    return {"rows_gap": rows_gap, "count_leaves": count_leaves,
            "desc_leaves": max(desc_leaves(d, want) for d in kept)}


def failed_passes(passes: list, rows_sent: int,
                  ref_counts: np.ndarray) -> int:
    """Passes whose rows or per-leaf counts differ from the reference."""
    return sum(
        int(p["rows"]) != rows_sent or p["counts"].shape != ref_counts.shape
        or bool((p["counts"] != ref_counts).any())
        for p in passes)
