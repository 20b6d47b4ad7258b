"""Numpy oracle for the fused ingestion path.

``fused_ingest_ref`` is the bit-identity oracle: route via the numpy
descent, tighten via the ``IncrementalTightener`` arithmetic, packaged as
the ``(bids, TightenPartial)`` pair every fused backend returns.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.qdtree import FrozenQdTree, IncrementalTightener


def fused_ingest_ref(tree: FrozenQdTree, records: np.ndarray):
    """Numpy bit-identity oracle: one batch routed + reduced per leaf.

    Exactly the two-pass arithmetic (``FrozenQdTree.route`` then
    ``IncrementalTightener.update``), returned in the fused-path shape:
    ``(bids int32, TightenPartial)``.
    """
    bids = tree.route(records)
    t = IncrementalTightener(tree)
    t.update(records, bids)
    return bids, t.as_partial()
