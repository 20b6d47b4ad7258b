"""Entry ``ingest``: a pass is one ``LayoutEngine.ingest`` call over every
batch (fused route and tighten, the default), which folds the rows into
the leaves' descriptions and applies them to the tree when it returns."""

from __future__ import annotations

METRIC = "ingest_rows_per_s"  # every row the passes folded, over the window


def run_pass(engine, batches, rec) -> dict:
    """One pass; ``rows`` is what the entry reports it folded."""
    with rec.entry_pass():
        report = engine.ingest(rec.batches(batches))
    return {"rows": report.n_records, "counts": report.block_sizes}
