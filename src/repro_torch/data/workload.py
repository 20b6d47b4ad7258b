"""Query-workload generators (paper Sec 7.2).

TPC-H: 15 templates (the 8 from Sun et al. + 7 extras the paper adds),
each instantiated with multiple random seeds — filters mirror the actual
TPC-H predicates that reach the denormalized line_item table, including
q19's disjunction-of-conjunctions and the advanced (column-vs-column)
predicates the paper highlights for q21/q12.

ErrorLog-Int/Ext: 1000 very selective queries of IN predicates over
categoricals + date ranges (paper: selectivity 0.0005% / 0.0697%).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.predicates import OP_GE, OP_GT, OP_LE, OP_LT, Schema
from repro_torch.core.query import AdvAtom, InAtom, Query, RangeAtom, Workload
from repro_torch.data import datagen

YEAR = 365


def _date_range(rng, span_days: int) -> tuple[int, int]:
    lo = int(rng.integers(0, datagen.DATE_DOM - span_days))
    return lo, lo + span_days


# --------------------------------------------------------------------------
# TPC-H templates. dim() lookups are by name so schema evolution is safe.
# --------------------------------------------------------------------------
def _tpch_templates(schema: Schema):
    d = schema.dim

    def q1(rng):  # shipdate <= date - delta  (scan-heavy)
        cutoff = int(rng.integers(datagen.DATE_DOM - 120, datagen.DATE_DOM - 1))
        return Query.conjunction([RangeAtom(d("l_shipdate"), OP_LE, cutoff)])

    def q3(rng):  # mktsegment = X and orderdate < D and shipdate > D
        day = int(rng.integers(YEAR, datagen.DATE_DOM - YEAR))
        return Query.conjunction([
            InAtom(d("c_mktsegment"), (int(rng.integers(0, 5)),)),
            RangeAtom(d("o_orderdate"), OP_LT, day),
            RangeAtom(d("l_shipdate"), OP_GT, day),
        ])

    def q4(rng):  # orderdate in quarter and commitdate < receiptdate
        lo, hi = _date_range(rng, 90)
        return Query.conjunction([
            RangeAtom(d("o_orderdate"), OP_GE, lo),
            RangeAtom(d("o_orderdate"), OP_LT, hi),
            AdvAtom(d("l_commitdate"), OP_LT, d("l_receiptdate")),
        ])

    def q5(rng):  # region + orderdate year
        lo, hi = _date_range(rng, YEAR)
        return Query.conjunction([
            InAtom(d("r_name"), (int(rng.integers(0, 5)),)),
            RangeAtom(d("o_orderdate"), OP_GE, lo),
            RangeAtom(d("o_orderdate"), OP_LT, hi),
        ])

    def q6(rng):  # shipdate year + discount band + quantity
        lo, hi = _date_range(rng, YEAR)
        disc = int(rng.integers(1, 9))
        return Query.conjunction([
            RangeAtom(d("l_shipdate"), OP_GE, lo),
            RangeAtom(d("l_shipdate"), OP_LT, hi),
            RangeAtom(d("l_discount"), OP_GE, disc - 1),
            RangeAtom(d("l_discount"), OP_LE, disc + 1),
            RangeAtom(d("l_quantity"), OP_LT, int(rng.integers(24, 26))),
        ])

    def q7(rng):  # two nations + shipdate window
        a, b = rng.choice(25, size=2, replace=False)
        lo, hi = _date_range(rng, 2 * YEAR)
        return Query.conjunction([
            InAtom(d("c_nationkey"), (int(a), int(b))),
            InAtom(d("s_nationkey"), (int(a), int(b))),
            RangeAtom(d("l_shipdate"), OP_GE, lo),
            RangeAtom(d("l_shipdate"), OP_LT, hi),
        ])

    def q8(rng):  # region + orderdate window + brand-ish part filter
        lo, hi = _date_range(rng, 2 * YEAR)
        return Query.conjunction([
            InAtom(d("r_name"), (int(rng.integers(0, 5)),)),
            RangeAtom(d("o_orderdate"), OP_GE, lo),
            RangeAtom(d("o_orderdate"), OP_LT, hi),
            InAtom(d("p_brand"), tuple(rng.choice(25, 3, replace=False).tolist())),
        ])

    def q9(rng):  # supplier nation + container
        return Query.conjunction([
            InAtom(d("s_nationkey"), tuple(rng.choice(25, 4, replace=False).tolist())),
            InAtom(d("p_container"), tuple(rng.choice(40, 8, replace=False).tolist())),
        ])

    def q10(rng):  # returnflag = R + orderdate quarter
        lo, hi = _date_range(rng, 90)
        return Query.conjunction([
            InAtom(d("l_returnflag"), (2,)),
            RangeAtom(d("o_orderdate"), OP_GE, lo),
            RangeAtom(d("o_orderdate"), OP_LT, hi),
        ])

    def q12(rng):  # shipmode pair + commit<receipt + ship<commit + receipt yr
        lo, hi = _date_range(rng, YEAR)
        modes = rng.choice(7, size=2, replace=False)
        return Query.conjunction([
            InAtom(d("l_shipmode"), tuple(int(x) for x in modes)),
            AdvAtom(d("l_commitdate"), OP_LT, d("l_receiptdate")),
            AdvAtom(d("l_shipdate"), OP_LT, d("l_commitdate")),
            RangeAtom(d("l_receiptdate"), OP_GE, lo),
            RangeAtom(d("l_receiptdate"), OP_LT, hi),
        ])

    def q14(rng):  # shipdate month
        lo, hi = _date_range(rng, 30)
        return Query.conjunction([
            RangeAtom(d("l_shipdate"), OP_GE, lo),
            RangeAtom(d("l_shipdate"), OP_LT, hi),
        ])

    def q17(rng):  # brand + container + small quantity
        return Query.conjunction([
            InAtom(d("p_brand"), (int(rng.integers(0, 25)),)),
            InAtom(d("p_container"), (int(rng.integers(0, 40)),)),
            RangeAtom(d("l_quantity"), OP_LT, int(rng.integers(3, 8))),
        ])

    def q18(rng):  # large quantity orders (scan-heavy)
        return Query.conjunction([
            RangeAtom(d("l_quantity"), OP_GT, int(rng.integers(44, 49))),
        ])

    def q19(rng):  # OR of three 6-filter conjunctions (the paper's example)
        def arm(brand_pool, containers, qlo, qspan, size_hi):
            q = int(rng.integers(*qlo))
            return [
                InAtom(d("p_brand"), (int(rng.choice(brand_pool)),)),
                InAtom(d("p_container"), tuple(int(c) for c in containers)),
                RangeAtom(d("l_quantity"), OP_GE, q),
                RangeAtom(d("l_quantity"), OP_LE, q + qspan),
                RangeAtom(d("p_size"), OP_GE, 1),
                RangeAtom(d("p_size"), OP_LE, size_hi),
                InAtom(d("l_shipinstruct"), (0,)),
                InAtom(d("l_shipmode"), (0, 1)),
            ]
        return Query.disjunction([
            arm(range(0, 8), rng.choice(40, 4, replace=False), (1, 11), 10, 5),
            arm(range(8, 16), rng.choice(40, 4, replace=False), (10, 20), 10, 10),
            arm(range(16, 25), rng.choice(40, 4, replace=False), (20, 30), 10, 15),
        ])

    def q21(rng):  # receiptdate > commitdate (self-join accelerator)
        return Query.conjunction([
            AdvAtom(d("l_receiptdate"), OP_GT, d("l_commitdate")),
            InAtom(d("s_nationkey"), (int(rng.integers(0, 25)),)),
            InAtom(d("l_linestatus"), (0,)),
        ])

    return {
        "q1": q1, "q3": q3, "q4": q4, "q5": q5, "q6": q6, "q7": q7,
        "q8": q8, "q9": q9, "q10": q10, "q12": q12, "q14": q14,
        "q17": q17, "q18": q18, "q19": q19, "q21": q21,
    }


def make_tpch_workload(
    schema: Schema, n_per_template: int = 10, seed: int = 0
) -> tuple[Workload, list[str]]:
    rng = np.random.default_rng(seed)
    templates = _tpch_templates(schema)
    queries, labels = [], []
    for name, fn in templates.items():
        for _ in range(n_per_template):
            queries.append(fn(rng))
            labels.append(name)
    return Workload(schema, tuple(queries)), labels


# --------------------------------------------------------------------------
# ErrorLog workloads: IN over categoricals + date ranges, ~5 dims touched
# --------------------------------------------------------------------------
def make_errorlog_int_workload(
    schema: Schema, n_queries: int = 1000, seed: int = 0
) -> tuple[Workload, list[str]]:
    rng = np.random.default_rng(seed)
    d = schema.dim
    queries = []
    for _ in range(n_queries):
        atoms = [
            InAtom(d("event_type"), tuple(
                int(x) for x in rng.choice(8, rng.integers(1, 3), replace=False)
            )),
            InAtom(d("os_version"), tuple(
                int(x) for x in rng.choice(64, rng.integers(1, 4), replace=False)
            )),
            InAtom(d("is_valid"), (1,)),
        ]
        if rng.random() < 0.8:  # date range
            lo = int(rng.integers(0, 7 * 24 - 12))
            atoms += [
                RangeAtom(d("ingest_date"), OP_GE, lo),
                RangeAtom(d("ingest_date"), OP_LT, lo + int(rng.integers(3, 13))),
            ]
        if rng.random() < 0.5:
            atoms.append(
                InAtom(d("component"), tuple(
                    int(x) for x in rng.choice(32, rng.integers(1, 3), replace=False)
                ))
            )
        queries.append(Query.conjunction(atoms))
    return Workload(schema, tuple(queries)), ["int"] * n_queries


def make_errorlog_ext_workload(
    schema: Schema, n_queries: int = 1000, seed: int = 0
) -> tuple[Workload, list[str]]:
    rng = np.random.default_rng(seed)
    d = schema.dim
    queries = []
    # queries concentrate on popular apps (zipf), like real dashboards
    p = 1.0 / np.arange(1, 3001) ** 1.1
    p /= p.sum()
    for _ in range(n_queries):
        atoms = [
            InAtom(d("app_id"), tuple(
                int(x) for x in rng.choice(3000, rng.integers(1, 4), replace=False, p=p)
            )),
        ]
        if rng.random() < 0.7:
            lo = int(rng.integers(0, 15 * 24 - 24))
            atoms += [
                RangeAtom(d("ingest_date"), OP_GE, lo),
                RangeAtom(d("ingest_date"), OP_LT, lo + int(rng.integers(6, 25))),
            ]
        if rng.random() < 0.6:
            atoms.append(InAtom(d("country"), tuple(
                int(x) for x in rng.choice(200, rng.integers(1, 4), replace=False)
            )))
        if rng.random() < 0.4:
            atoms.append(InAtom(d("event_type"), tuple(
                int(x) for x in rng.choice(16, rng.integers(1, 3), replace=False)
            )))
        queries.append(Query.conjunction(atoms))
    return Workload(schema, tuple(queries)), ["ext"] * n_queries


WORKLOADS = {
    "tpch": make_tpch_workload,
    "errorlog_int": make_errorlog_int_workload,
    "errorlog_ext": make_errorlog_ext_workload,
}
