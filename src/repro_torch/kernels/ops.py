"""Operand packing for the query kernel, and its one-shot entry point.

The LayoutEngine's torch backend caches the packed operands (leaf
descriptions per description version, workload tensors per workload);
``query_intersect`` below packs and runs once, for callers without an
engine.  Everything returned is numpy and bit-identical to the numpy
oracles in ``repro_torch.core``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import query as qry
from repro_torch.core.predicates import Schema
from repro_torch.core.qdtree import FrozenQdTree
from repro_torch.kernels import query_intersect as qk


def pack_workload(wt: qry.WorkloadTensors, n_adv: int) -> dict:
    """Conjunct descriptions as kernel operands (numpy, host).

    ``q_reqt``/``q_reqf`` mark the conjuncts that require each advanced
    cut true / false, ``max(n_adv, 1)`` columns wide like the leaves'.
    """
    a3 = max(n_adv, 1)
    reqt = np.zeros((wt.n_conjuncts, a3), np.uint8)
    reqf = np.zeros((wt.n_conjuncts, a3), np.uint8)
    reqt[:, :n_adv] = wt.q_adv[:, :n_adv] == qry.ADV_TRUE
    reqf[:, :n_adv] = wt.q_adv[:, :n_adv] == qry.ADV_FALSE
    return {
        "q_lo": wt.q_lo.astype(np.int32),
        "q_hi": wt.q_hi.astype(np.int32),
        "q_cat": np.ascontiguousarray(wt.q_cat, dtype=np.uint8),
        "q_reqt": reqt,
        "q_reqf": reqf,
    }


def query_layout(schema: Schema, n_adv: int) -> dict:
    """Which columns are numeric, and the categorical bit segments."""
    off = schema.cat_offsets
    cat_dims = np.nonzero(schema.is_categorical)[0]
    starts = off[cat_dims].astype(np.int32)
    ends = (starts + schema.doms[cat_dims]).astype(np.int32)
    return {
        "num_dims": np.nonzero(~schema.is_categorical)[0].astype(np.int32),
        "seg_start": starts,
        "seg_end": ends,
        "segments": tuple(zip(starts.tolist(), ends.tolist())),
        "n_adv": int(n_adv),
    }


def query_intersect(
    tree: FrozenQdTree,
    wt: qry.WorkloadTensors,
    block_sizes: np.ndarray | None = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (query_hits (L, n_queries) bool, scanned_per_conj (n_conj,)).

    ``block_sizes`` defaults to the tree's own (its last tightening's
    counts).  ``device`` None is the GPU; pass ``"cpu"`` for the plain
    version.  Mirrors ``rewards.block_query_hits`` bit-exactly; scanned
    counts are exact int64.
    """
    # importing repro_torch.engine loads the backends, which import this
    # module: import the plan helpers at call time
    from repro_torch.engine.plan import (
        pack_leaf_descs, resolve_device, to_device,
    )

    dev = resolve_device(device)
    n_adv = tree.cuts.n_adv
    leaf = pack_leaf_descs(tree)
    if block_sizes is not None:
        leaf["size"] = np.asarray(block_sizes, np.int64)
    hits, scanned = qk.query_intersect(
        to_device(leaf, dev),
        to_device(pack_workload(wt, n_adv), dev),
        to_device(query_layout(tree.schema, n_adv), dev),
    )
    conj_hits = hits.cpu().numpy().astype(bool)
    return qry.queries_intersect(conj_hits, wt), scanned.cpu().numpy()
