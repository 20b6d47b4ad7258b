"""Synthetic dataset generators mirroring the paper's three workloads
(Sec 7.2).  TPC-H dbgen and the proprietary ErrorLog datasets are not
available offline; these generators match the published *statistics* —
column families, domain cardinalities, correlations that make advanced
cuts useful, and workload selectivities (DESIGN.md §9).

All outputs are dictionary-encoded int32 matrices + a Schema.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.predicates import Column, Schema

DATE_DOM = 2526  # days in TPC-H's 1992-01-01 .. 1998-12-01 span


def tpch_like_schema() -> Schema:
    """Denormalized line_item-centric table (the paper's 68-column table,
    restricted to the columns its queries actually touch + fillers)."""
    return Schema((
        Column("l_shipdate", "numeric", DATE_DOM),
        Column("l_commitdate", "numeric", DATE_DOM),
        Column("l_receiptdate", "numeric", DATE_DOM),
        Column("l_quantity", "numeric", 51),
        Column("l_discount", "numeric", 11),
        Column("l_extendedprice", "numeric", 10000),
        Column("o_orderdate", "numeric", DATE_DOM),
        Column("o_totalprice", "numeric", 10000),
        Column("p_size", "numeric", 51),
        Column("p_retailprice", "numeric", 2000),
        Column("l_shipmode", "categorical", 7),
        Column("l_shipinstruct", "categorical", 4),
        Column("l_returnflag", "categorical", 3),
        Column("l_linestatus", "categorical", 2),
        Column("p_brand", "categorical", 25),
        Column("p_container", "categorical", 40),
        Column("c_mktsegment", "categorical", 5),
        Column("r_name", "categorical", 5),
        Column("o_orderpriority", "categorical", 5),
        Column("c_nationkey", "categorical", 25),
        Column("s_nationkey", "categorical", 25),
    ))


def make_tpch_like(n_rows: int, seed: int = 0) -> tuple[Schema, np.ndarray]:
    """Uniform-ish TPC-H style data with the date correlations that make the
    paper's advanced cuts (commit < receipt, ship < commit) selective."""
    schema = tpch_like_schema()
    rng = np.random.default_rng(seed)
    n = n_rows
    ship = rng.integers(0, DATE_DOM - 120, n)
    # TPC-H semantics: commit ≈ order + 30..90, receipt = ship + 1..30.
    # Generate so that both advanced-cut polarities are non-trivially present.
    commit = ship + rng.integers(-30, 60, n)
    receipt = ship + rng.integers(1, 31, n)
    commit = np.clip(commit, 0, DATE_DOM - 1)
    receipt = np.clip(receipt, 0, DATE_DOM - 1)
    orderdate = np.clip(ship - rng.integers(1, 121, n), 0, DATE_DOM - 1)
    cols = [
        ship,
        commit,
        receipt,
        rng.integers(1, 51, n),  # quantity
        rng.integers(0, 11, n),  # discount
        rng.integers(0, 10000, n),  # extendedprice
        orderdate,
        rng.integers(0, 10000, n),  # totalprice
        rng.integers(1, 51, n),  # p_size
        rng.integers(0, 2000, n),  # retailprice
        rng.integers(0, 7, n),  # shipmode
        rng.integers(0, 4, n),  # shipinstruct
        rng.integers(0, 3, n),  # returnflag
        rng.integers(0, 2, n),  # linestatus
        rng.integers(0, 25, n),  # brand
        rng.integers(0, 40, n),  # container
        rng.integers(0, 5, n),  # mktsegment
        rng.integers(0, 5, n),  # r_name
        rng.integers(0, 5, n),  # orderpriority
        rng.integers(0, 25, n),  # c_nationkey
        rng.integers(0, 25, n),  # s_nationkey
    ]
    return schema, np.stack(cols, axis=1).astype(np.int32)


# ---------------------------------------------------------------------------
# ErrorLog-Int: 8-value event type, ~1 week of ingest, very selective queries
# ---------------------------------------------------------------------------
def errorlog_int_schema() -> Schema:
    return Schema((
        Column("ingest_date", "numeric", 7 * 24),  # hourly over one week
        Column("build_date", "numeric", 400),
        Column("event_type", "categorical", 8),
        Column("os_version", "categorical", 64),
        Column("is_valid", "categorical", 2),
        Column("severity", "categorical", 6),
        Column("component", "categorical", 32),
        Column("machine_class", "categorical", 12),
        Column("error_code", "numeric", 5000),
        Column("session_len", "numeric", 1000),
    ))


def make_errorlog_int(n_rows: int, seed: int = 0) -> tuple[Schema, np.ndarray]:
    schema = errorlog_int_schema()
    rng = np.random.default_rng(seed)
    n = n_rows

    def zipf_cat(dom, a=1.5):
        """Skewed categorical — real logs are heavily skewed."""
        p = 1.0 / np.arange(1, dom + 1) ** a
        p /= p.sum()
        return rng.choice(dom, size=n, p=p)

    event = zipf_cat(8)
    osv = zipf_cat(64, a=1.2)
    # correlations: event type ↔ component, build date ↔ os version
    component = (osv // 2 + rng.integers(0, 4, n)) % 32
    build = np.clip(
        (osv.astype(np.int64) * 6) + rng.integers(0, 24, n), 0, 399
    )
    cols = [
        rng.integers(0, 7 * 24, n),  # ingest_date
        build,
        event,
        osv,
        (rng.random(n) < 0.98).astype(np.int64),  # is_valid mostly true
        zipf_cat(6),
        component,
        zipf_cat(12),
        zipf_cat(5000, a=1.3),  # error_code: heavily skewed numeric
        rng.integers(0, 1000, n),
    ]
    return schema, np.stack(cols, axis=1).astype(np.int32)


# ---------------------------------------------------------------------------
# ErrorLog-Ext: ~3600 distinct categorical values, 15 days, 0.07% selectivity
# ---------------------------------------------------------------------------
def errorlog_ext_schema() -> Schema:
    return Schema((
        Column("ingest_date", "numeric", 15 * 24),
        Column("build_date", "numeric", 600),
        Column("app_id", "categorical", 3000),  # the big domain
        Column("event_type", "categorical", 16),
        Column("os_version", "categorical", 128),
        Column("country", "categorical", 200),
        Column("severity", "categorical", 6),
        Column("arch", "categorical", 4),
        Column("error_code", "numeric", 8000),
        Column("uptime", "numeric", 2000),
    ))


def make_errorlog_ext(n_rows: int, seed: int = 0) -> tuple[Schema, np.ndarray]:
    schema = errorlog_ext_schema()
    rng = np.random.default_rng(seed)
    n = n_rows

    def zipf_cat(dom, a=1.4):
        p = 1.0 / np.arange(1, dom + 1) ** a
        p /= p.sum()
        return rng.choice(dom, size=n, p=p)

    app = zipf_cat(3000, a=1.1)
    cols = [
        rng.integers(0, 15 * 24, n),
        np.clip(app // 8 + rng.integers(0, 256, n), 0, 599),  # build~app corr
        app,
        zipf_cat(16),
        zipf_cat(128, a=1.2),
        zipf_cat(200, a=1.1),
        zipf_cat(6),
        zipf_cat(4, a=1.0),
        zipf_cat(8000, a=1.2),
        rng.integers(0, 2000, n),
    ]
    return schema, np.stack(cols, axis=1).astype(np.int32)


GENERATORS = {
    "tpch": make_tpch_like,
    "errorlog_int": make_errorlog_int,
    "errorlog_ext": make_errorlog_ext,
}
