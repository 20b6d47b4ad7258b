#!/usr/bin/env python3
"""Model ``fused_ingest_shared``'s shared-memory traffic on a layout's
rows, on the CPU, in plain PyTorch.

    PYTHONPATH=src python3 tools/fold_access_stats.py
        [--config tpch-sf100-b600k | --layout FILE] [--seed 7]
        [--order generated | --order sort_by:l_shipdate] [--batches 4]
        [--batch-rows N] [--table-rows N] [--sms 132]

The rows are the benchmark's (``qdbench/datagen.py`` from ``--seed``):
the first ``--batches`` batches of ``--batch-rows`` rows of a pass over a
table of ``--table-rows`` rows (both default to the configuration's batch
and resident rows), in generated order, or stably sorted by a column as
the benchmark's ``stream`` mix sorts its resident rows (two passes over
the table's chunks, keeping only the batches asked for).  They are routed
by ``qdbench/reference``.  A batch's 32-row tiles go to blocks as the
kernel's persistent grid hands them out: warp w of block b takes tile
b W + w, then every G W further (W the plan's warps, G = min(tiles / W,
``--sms``), one block an SM).

For each batch, in pass order, it prints:

* distinct leaves in a warp's 32-row tile (mean over tiles);
* rows of one leaf that one block sees (mean over the (block, leaf) pairs
  with a row);
* shared atomics a row, counted one row at a time in row order within
  each block: min and max, categorical words, advanced-cut words and
  their sum, from identity starts and from seeded starts (the pass's
  running aggregates after its earlier batches; a pass's first batch
  starts from identities either way, as a fresh accumulator holds them).
  A warp's lanes run together, so lanes of one leaf that read before each
  other's atomics land each fire: these counts are a floor;
* the (block, leaf) pairs a seeded block merges beyond their counts, and
  their share of blocks x leaves (a pass's first fold is not seeded: its
  blocks flush every leaf);
* bank wavefronts of one ``lo[leaf * d + j]`` read-check (mean over full
  tiles): the most distinct leaves of a tile that fall in one of the 32
  banks.

Then one JSON line with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from qdbench import datagen  # noqa: E402
from qdbench import layout as qlayout  # noqa: E402
from qdbench import reference  # noqa: E402
from repro_torch.kernels import fused_ingest as tfk  # noqa: E402

OPTIN = 232_448  # an H100's opt-in shared bytes a block
LANES = 32
BANKS = 32
# above every int32 code: the identity of a min, and of a max negated
TOP = 1 << 32


def plan_shape(ref: reference.Layout) -> tuple:
    """The tree's shape as ``fused_ingest.layout_plan`` takes it."""
    n_adv = len(ref.adv)
    return (ref.n_leaves, ref.ndims, -(-ref.bits // 32), -(-n_adv // 32),
            len(ref.cat_dims), n_adv)


def tile_blocks(m: int, warps: int, sms: int) -> torch.Tensor:
    """(m,) block of each row under the kernel's persistent grid."""
    tiles = -(-m // LANES)
    grid = max(1, min(-(-tiles // warps), sms))
    tile = torch.arange(m) // LANES
    return (tile % (grid * warps)) // warps


def sorted_window(table_rows: int, seed: int, column: int, start: int,
                  n: int) -> torch.Tensor:
    """Rows ``start .. start + n`` of ``datagen.generate_sorted(table_rows,
    seed, "cpu", column)``, without the whole table: the same counting
    sort, keeping only the rows placed in the window."""
    dom = datagen.COLUMNS[column][2]
    counts = torch.zeros(dom, dtype=torch.int64)
    for c, s, e in datagen.chunks(table_rows):
        key = datagen.draw_chunk(e - s, seed, c, "cpu")[column].long()
        counts += torch.bincount(key, minlength=dom)
    place = torch.cumsum(counts, 0) - counts
    out = torch.empty((n, datagen.NDIMS), dtype=torch.int32)
    for c, s, e in datagen.chunks(table_rows):
        cols = datagen.draw_chunk(e - s, seed, c, "cpu")
        key = cols[column].long()
        order = torch.sort(key, stable=True).indices
        k = key.index_select(0, order)
        have = torch.bincount(key, minlength=dom)
        first = torch.cumsum(have, 0) - have
        pos = (torch.arange(e - s) - first.index_select(0, k)
               + place.index_select(0, k))
        keep = (pos >= start) & (pos < start + n)
        out[pos[keep] - start] = cols.t().index_select(0, order[keep])
        place += have
    return out


def shared_atomics(ref: reference.Layout, rows: torch.Tensor,
                   leaf: torch.Tensor, block: torch.Tensor,
                   start: reference.Fold) -> dict:
    """The shared atomics of folding ``rows`` (routed to ``leaf``, given
    to ``block``), one row at a time in row order within each block, each
    block's aggregates starting at ``start``; and the (block, leaf) pairs
    with a row, and those where an atomic ran."""
    m, d = rows.shape
    L = ref.n_leaves
    pair = block * L + leaf
    order = torch.sort(pair, stable=True).indices
    p, lf = pair[order], leaf[order]
    first = torch.ones(m, dtype=torch.bool)
    first[1:] = p[1:] != p[:-1]
    gid = torch.cumsum(first.long(), 0) - 1
    n_groups = int(gid[-1]) + 1 if m else 0
    low = (1 << 34) - 1
    # a later group's keys lie below every earlier one's: cummin restarts
    high = (n_groups - gid) << 34
    changed = torch.zeros(int(block.max()) * L + L if m else 0,
                          dtype=torch.bool)
    seen = start.counts.index_select(0, lf) > 0
    minmax = 0
    for j in range(d):
        v = rows[order, j].long()
        lo0 = torch.where(seen, start.lo[lf, j], TOP)
        hi0 = torch.where(seen, -(start.hi[lf, j] - 1), TOP)
        for w, init in ((v, lo0), (-v, hi0)):
            incl = torch.cummin(high | (w + (1 << 31)), 0).values
            prev = torch.full_like(w, TOP)
            prev[1:] = (incl[:-1] & low) - (1 << 31)
            prev = torch.where(first, TOP, prev)
            hit = w < torch.minimum(prev, init)
            minmax += int(hit.sum())
            changed[p[hit]] = True

    def firsts(key: torch.Tensor, already: torch.Tensor,
               pairs: torch.Tensor) -> int:
        # one atomic for each key's first row, unless the start has its bit
        uniq, inv = torch.unique(key, return_inverse=True)
        pos = torch.full((uniq.numel(),), m, dtype=torch.int64)
        pos.scatter_reduce_(0, inv, torch.arange(key.numel()), "amin")
        new = ~already[pos]
        changed[pairs[pos[new]]] = True
        return int(new.sum())

    cat = 0
    for c in ref.cat_dims:
        bit = int(ref.cat_off[c]) + rows[:, c].long()
        bit = bit.clamp(0, ref.bits - 1)
        cat += firsts(pair * ref.bits + bit, start.cat[leaf, bit], pair)
    adv = 0
    n_adv = len(ref.adv)
    for j, (a, op, b) in enumerate(ref.adv):
        slot = (~reference.OPS[op](rows[:, a], rows[:, b])).long()
        adv += firsts((pair * n_adv + j) * 2 + slot, start.adv[leaf, j, slot],
                      pair)
    return {"minmax": minmax / m, "cat": cat / m, "adv": adv / m,
            "total": (minmax + cat + adv) / m,
            "pairs": n_groups, "merged_pairs": int(changed.sum())}


def tile_stats(leaf: torch.Tensor, L: int, d: int) -> dict:
    """Distinct leaves a 32-row tile (every tile), and the bank wavefronts
    of one ``lo[leaf * d + j]`` read-check (full tiles)."""
    m = leaf.numel()
    tile = torch.arange(m) // LANES
    tiles = -(-m // LANES)
    uniq = torch.unique(tile * L + leaf)
    distinct = torch.bincount(uniq // L, minlength=tiles).double()
    full = m // LANES
    uf = uniq[uniq // L < full]
    bank = ((uf % L) * d) % BANKS
    per_bank = torch.bincount((uf // L) * BANKS + bank,
                              minlength=full * BANKS).view(full, BANKS)
    return {"leaves_a_tile": float(distinct.mean()),
            "wavefronts": float(per_bank.max(1).values.double().mean())
            if full else 0.0}


def batch_stats(ref: reference.Layout, batches: list, warps: int,
                sms: int) -> list:
    """The numbers above for each batch of a pass, in order."""
    running = reference.Fold.empty(ref)
    out = []
    for rank, rows in enumerate(batches):
        leaf = ref.route(rows)
        block = tile_blocks(rows.shape[0], warps, sms)
        fresh = shared_atomics(ref, rows, leaf, block,
                               reference.Fold.empty(ref))
        seeded = shared_atomics(ref, rows, leaf, block, running)
        blocks = int(block.max()) + 1
        out.append({
            "rank": rank, "rows": int(rows.shape[0]), "blocks": blocks,
            **tile_stats(leaf, ref.n_leaves, ref.ndims),
            "rows_a_block_leaf": rows.shape[0] / fresh["pairs"],
            "identity": {k: fresh[k] for k in ("minmax", "cat", "adv",
                                               "total")},
            "seeded": {k: seeded[k] for k in ("minmax", "cat", "adv",
                                              "total")},
            "merged_pairs": seeded["merged_pairs"],
            "merged_share": seeded["merged_pairs"] / (blocks * ref.n_leaves),
        })
        running.add(ref, rows, leaf)
    return out


def pass_rows(order: str, seed: int, n: int, table_rows: int) -> torch.Tensor:
    """The first ``n`` rows of a pass in ``order``."""
    if order == "generated":
        return datagen.generate(n, seed, "cpu")
    kind, _, column = order.partition(":")
    names = [name for name, _, _ in datagen.schema_columns()]
    if kind != "sort_by" or column not in names:
        raise ValueError(f"order {order!r}: 'generated' or 'sort_by:<column>'"
                         f" of {names}")
    return sorted_window(table_rows, seed, names.index(column), 0, n)


def table(stats: list) -> str:
    head = ("| rank | leaves a tile | rows a (block, leaf) | atomics a row, "
            "identity (min/max, cat, adv) | seeded | merged pairs (share) | "
            "wavefronts a read-check |\n|---|---|---|---|---|---|---|")
    lines = [head]
    for s in stats:
        i, z = s["identity"], s["seeded"]
        lines.append(
            f"| {s['rank']} | {s['leaves_a_tile']:.2f} | "
            f"{s['rows_a_block_leaf']:.1f} | {i['total']:.2f} "
            f"({i['minmax']:.2f}, {i['cat']:.2f}, {i['adv']:.2f}) | "
            f"{z['total']:.3f} ({z['minmax']:.3f}, {z['cat']:.3f}, "
            f"{z['adv']:.3f}) | {s['merged_pairs']} "
            f"({100 * s['merged_share']:.2f}%) | {s['wavefronts']:.2f} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="tpch-sf100-b600k")
    ap.add_argument("--layout", type=Path, default=None,
                    help="a layout .npz (FrozenQdTree.to_arrays); its digest "
                    "is not checked")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--order", default="generated")
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--batch-rows", type=int, default=None)
    ap.add_argument("--table-rows", type=int, default=None)
    ap.add_argument("--sms", type=int, default=132)
    args = ap.parse_args(argv)
    config = qlayout.load_config(args.config)
    if args.layout is None:
        arrays = qlayout.load(config)
    else:
        with np.load(args.layout, allow_pickle=False) as z:
            arrays = {k: np.array(z[k]) for k in z.files}
    batch_rows = args.batch_rows or config["batch_rows"]
    table_rows = args.table_rows or config["resident_rows"]
    n = args.batches * batch_rows
    if n > table_rows:
        raise SystemExit(f"{args.batches} batches of {batch_rows} rows pass "
                         f"the table's {table_rows}")
    ref = reference.Layout(arrays, "cpu")
    warps = tfk.layout_plan(plan_shape(ref), OPTIN).warps
    rows = pass_rows(args.order, args.seed, n, table_rows)
    stats = batch_stats(ref, list(rows.split(batch_rows)), warps, args.sms)
    print(f"{args.config if args.layout is None else args.layout}: "
          f"{ref.n_leaves} leaves, {ref.ndims} columns, {warps} warps a "
          f"block, order {args.order}, seed {args.seed}, table {table_rows} "
          f"rows")
    print(table(stats))
    print(json.dumps({"order": args.order, "seed": args.seed,
                      "warps": warps, "batches": stats}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
