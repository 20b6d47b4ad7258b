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


def words(bits: int) -> int:
    """32-bit words that hold ``bits`` bits (at least one)."""
    return max(-(-int(bits) // 32), 1)


def pack_words(bits: np.ndarray, n_words: int) -> np.ndarray:
    """(n, nbits) bool → (n, n_words) int32, bit b in word b // 32 at
    b % 32: how the kernels hold bit sets."""
    n, nbits = bits.shape
    full = np.zeros((n, n_words * 32), np.uint8)
    full[:, :nbits] = bits
    packed = np.packbits(full, axis=1, bitorder="little")
    return np.ascontiguousarray(packed).view("<i4").astype(np.int32)


def unpack_words(w: np.ndarray, nbits: int) -> np.ndarray:
    """(n, words) int32 → (n, nbits) bool: the inverse of
    :func:`pack_words`."""
    w = np.ascontiguousarray(w, dtype="<i4")
    u8 = w.view(np.uint8).reshape(w.shape[0], -1)
    return np.unpackbits(u8, axis=1, bitorder="little")[:, :nbits].astype(bool)


def query_layout(schema: Schema, n_adv: int) -> dict:
    """Which columns are numeric, and the categorical segments as words.

    Segment k covers bits ``[start_k, end_k)`` of the categorical bit
    space; its entries ``seg_ranges[k]`` name the 32-bit words it touches
    (``seg_word``) with the bits of the segment in each (``seg_mask``).
    ``seg_end`` is each segment's end in the entry list.  ``cw``/``aw``
    are the words of a categorical / advanced-cut bit set.
    """
    off = schema.cat_offsets
    cat_dims = np.nonzero(schema.is_categorical)[0]
    starts = off[cat_dims].astype(np.int64)
    ends = starts + schema.doms[cat_dims]
    seg_word, seg_mask, seg_ranges = [], [], []
    for s, e in zip(starts.tolist(), ends.tolist()):
        first = len(seg_word)
        for w in range(s // 32, (e - 1) // 32 + 1):
            lo, hi = max(s, 32 * w) - 32 * w, min(e, 32 * w + 32) - 32 * w
            mask = ((1 << hi) - 1) ^ ((1 << lo) - 1)
            seg_word.append(w)
            seg_mask.append(mask - (1 << 32) if mask >= 1 << 31 else mask)
        seg_ranges.append((first, len(seg_word)))
    return {
        "num_dims": np.nonzero(~schema.is_categorical)[0].astype(np.int32),
        "seg_word": np.asarray(seg_word, np.int32),
        "seg_mask": np.asarray(seg_mask, np.int32),
        "seg_end": np.asarray([e for _, e in seg_ranges], np.int32),
        "seg_ranges": tuple(seg_ranges),
        "n_adv": int(n_adv),
        "cw": words(schema.total_cat_bits),
        "aw": words(n_adv),
    }


def pack_workload(wt: qry.WorkloadTensors, layout: dict) -> dict:
    """Conjunct descriptions as kernel operands (numpy, host).

    ``desc`` holds one int32 row per conjunct: numeric lo, numeric hi,
    the conjunct's categorical words ANDed with each segment entry's mask,
    then the words of the advanced cuts it requires true and false.
    """
    nd, n_adv, aw = layout["num_dims"], layout["n_adv"], layout["aw"]
    cat = pack_words(wt.q_cat.astype(bool), layout["cw"])
    seg = cat[:, layout["seg_word"]] & layout["seg_mask"][None, :]
    req = wt.q_adv[:, :n_adv]
    desc = np.concatenate([
        wt.q_lo[:, nd], wt.q_hi[:, nd], seg,
        pack_words(req == qry.ADV_TRUE, aw),
        pack_words(req == qry.ADV_FALSE, aw),
    ], axis=1)
    return {"desc": np.ascontiguousarray(desc, dtype=np.int32)}


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
    layout = query_layout(tree.schema, tree.cuts.n_adv)
    leaf = pack_leaf_descs(tree, layout)
    if block_sizes is not None:
        leaf["size"] = np.asarray(block_sizes, np.int64)
    hits, scanned = qk.query_intersect(
        to_device(leaf, dev),
        to_device(pack_workload(wt, layout), dev),
        to_device(layout, dev),
    )
    conj_hits = hits.cpu().numpy().astype(bool)
    return qry.queries_intersect(conj_hits, wt), scanned.cpu().numpy()
