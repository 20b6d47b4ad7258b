"""The benchmark's frozen TPC-H-like generator, in PyTorch.

A copy of the distributions of ``repro_torch.data.datagen.make_tpch_like``
(21 dictionary-coded int32 columns, 84 B a row: lineitem denormalized with
its order, part, customer and nation columns, with the date correlations
that make the advanced cuts selective), written so that it runs on the
card from a seed.  It is the yardstick's own copy: a later change to the
program's generator moves nothing here.

The rows are drawn in chunks of :data:`CHUNK` rows.  Chunk ``c`` has a
``torch.Generator`` of its own, seeded from ``(seed, c)`` (chunk 0 from
``seed`` itself), and draws each column as one ``torch.randint`` call, in
the order of :data:`COLUMNS`.  So the same seed on the same kind of device
gives the same rows, any chunk can be drawn again alone, and a table of
tens of GB is made without a temporary of its size.

Where this copy departs from TPC-H's own generator (dbgen), as the
program's does: ``l_returnflag`` and ``l_linestatus`` are uniform and
independent (dbgen sets them from the receipt and ship dates against
1995-06-17); ``l_extendedprice`` is a uniform code, independent of
``l_quantity`` and ``p_retailprice``; ``l_commitdate`` is drawn around the
ship date (dbgen draws it from the order date + 30..90 days).
"""

from __future__ import annotations

import torch

DATE_DOM = 2526  # days in TPC-H's 1992-01-01 .. 1998-12-01 span
SHIP_DAYS = DATE_DOM - 120  # l_shipdate's values: 0 .. SHIP_DAYS - 1
CHUNK = 1 << 22  # rows drawn from one generator

# (name, kind, domain, draw): "uniform" draws are randint(lo, hi); the
# dates are drawn as offsets from l_shipdate and clipped to the domain
COLUMNS = (
    ("l_shipdate", "numeric", DATE_DOM, ("uniform", 0, SHIP_DAYS)),
    ("l_commitdate", "numeric", DATE_DOM, ("after_ship", -30, 60)),
    ("l_receiptdate", "numeric", DATE_DOM, ("after_ship", 1, 31)),
    ("l_quantity", "numeric", 51, ("uniform", 1, 51)),
    ("l_discount", "numeric", 11, ("uniform", 0, 11)),
    ("l_extendedprice", "numeric", 10000, ("uniform", 0, 10000)),
    ("o_orderdate", "numeric", DATE_DOM, ("before_ship", 1, 121)),
    ("o_totalprice", "numeric", 10000, ("uniform", 0, 10000)),
    ("p_size", "numeric", 51, ("uniform", 1, 51)),
    ("p_retailprice", "numeric", 2000, ("uniform", 0, 2000)),
    ("l_shipmode", "categorical", 7, ("uniform", 0, 7)),
    ("l_shipinstruct", "categorical", 4, ("uniform", 0, 4)),
    ("l_returnflag", "categorical", 3, ("uniform", 0, 3)),
    ("l_linestatus", "categorical", 2, ("uniform", 0, 2)),
    ("p_brand", "categorical", 25, ("uniform", 0, 25)),
    ("p_container", "categorical", 40, ("uniform", 0, 40)),
    ("c_mktsegment", "categorical", 5, ("uniform", 0, 5)),
    ("r_name", "categorical", 5, ("uniform", 0, 5)),
    ("o_orderpriority", "categorical", 5, ("uniform", 0, 5)),
    ("c_nationkey", "categorical", 25, ("uniform", 0, 25)),
    ("s_nationkey", "categorical", 25, ("uniform", 0, 25)),
)
NDIMS = len(COLUMNS)
ROW_BYTES = 4 * NDIMS
M64 = (1 << 64) - 1


def schema_columns() -> list[tuple[str, str, int]]:
    """``(name, kind, domain)`` of each column, in order: what a layout
    file's ``schema`` entry holds."""
    return [(name, kind, dom) for name, kind, dom, _ in COLUMNS]


def chunk_seed(seed: int, chunk: int) -> int:
    """The generator seed of chunk ``chunk`` (a splitmix64 step over the
    two; chunk 0 takes ``seed`` as it is)."""
    if chunk == 0:
        return int(seed) % (1 << 64)
    z = (int(seed) * 0x9E3779B97F4A7C15 + chunk * 0xBF58476D1CE4E5B9) & M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
    return z ^ (z >> 31)


def chunks(n_rows: int):
    """``(chunk, start, stop)`` of each chunk of ``n_rows`` rows."""
    for c, s in enumerate(range(0, n_rows, CHUNK)):
        yield c, s, min(s + CHUNK, n_rows)


def draw_chunk(n: int, seed: int, chunk: int, device) -> torch.Tensor:
    """``(NDIMS, n)`` int32 columns of chunk ``chunk``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(chunk_seed(seed, chunk))
    cols = torch.empty((NDIMS, n), dtype=torch.int32, device=device)
    for j, (_, _, dom, (draw, lo, hi)) in enumerate(COLUMNS):
        torch.randint(lo, hi, (n,), generator=gen, device=device,
                      dtype=torch.int32, out=cols[j])
        if draw == "after_ship":
            cols[j].add_(cols[0]).clamp_(0, dom - 1)
        elif draw == "before_ship":
            torch.sub(cols[0], cols[j], out=cols[j]).clamp_(0, dom - 1)
    return cols


def generate(n_rows: int, seed: int, device) -> torch.Tensor:
    """``(n_rows, 21)`` int32 rows on ``device``, drawn from ``seed``."""
    out = torch.empty((n_rows, NDIMS), dtype=torch.int32,
                      device=torch.device(device))
    for c, s, e in chunks(n_rows):
        out[s:e].copy_(draw_chunk(e - s, seed, c, device).t())
    return out


def generate_sorted(n_rows: int, seed: int, device,
                    column: int) -> torch.Tensor:
    """The rows of ``generate(n_rows, seed, device)``, stably sorted by
    ``column``, made without a second table: a counting sort over the
    column's domain, each chunk drawn twice (once for the counts, once to
    place its rows)."""
    dom = COLUMNS[column][2]
    device = torch.device(device)
    counts = torch.zeros(dom, dtype=torch.int64, device=device)
    for c, s, e in chunks(n_rows):
        key = draw_chunk(e - s, seed, c, device)[column].long()
        counts += torch.bincount(key, minlength=dom)
    # the next free place of each key, in rows of keys below it and rows
    # of its own placed from earlier chunks
    place = torch.cumsum(counts, 0) - counts
    out = torch.empty((n_rows, NDIMS), dtype=torch.int32, device=device)
    for c, s, e in chunks(n_rows):
        cols = draw_chunk(e - s, seed, c, device)
        key = cols[column].long()
        order = torch.sort(key, stable=True).indices
        k = key.index_select(0, order)
        have = torch.bincount(key, minlength=dom)
        first = torch.cumsum(have, 0) - have  # of each key in the chunk
        pos = (torch.arange(e - s, device=device) - first.index_select(0, k)
               + place.index_select(0, k))
        out.index_copy_(0, pos, cols.t().index_select(0, order))
        place += have
    return out
