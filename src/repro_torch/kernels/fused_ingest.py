"""Fused single-pass ingestion: route + per-leaf tightening aggregates.

The two-pass path reads every record twice — once to route it
(``route_records.route``, paper Sec 3.1) and once to min-max-
tighten its destination leaf's description (``IncrementalTightener``,
Sec 3.2).  :meth:`IngestAccumulator.fold` does both in one pass over a
batch and folds the batch into the accumulator: one set of per-leaf
aggregates on the device that lives across every batch of a stream and
is copied to the host once, at the end (:meth:`IngestAccumulator.partial`).
Min, max, add and or are associative, so folding batch after batch equals
one fold of their concatenation, bit for bit.

On a CUDA tensor ``fold`` launches one design of
``csrc/fused_ingest.cu``: the shared-memory kernel when the tree's
aggregates fit a block's shared memory, else the leafwise design (route
once, sort the rows by leaf, fold each leaf's rows with one owner: four
kernels in stream order) where its histogram fits beside the route's
block, else the one-thread-a-record global kernel.  The cluster kernel,
whose cluster of blocks splits the aggregates, runs when forced (on an
H100 the leafwise design beat it where it had been planned, PERF.md §6).
The choice, the warps a block, the cluster's size and its leaf split are
planned once a shape, not once a batch (:func:`layout_plan`, pure
arithmetic on the shape and the card's shared bytes), or pinned by the
caller (the autotuner's geometry, ``engine/autotune.py``), and checked
against the card (``fused_ingest_plan``).
The plain PyTorch version beside them evaluates the full predicate
matrix, locates leaves in path-constraint form and folds with scatters
into the same accumulator layout; the wrapper takes it only for a tensor
on the CPU.

Every row of the batch is a real record: the port never pads a batch, so
there is no validity mask.
"""

from __future__ import annotations

# qdlint: deterministic-module

import contextlib
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.qdtree import FrozenQdTree, TightenPartial
from repro_torch.core.routing import adv_truth
from repro_torch.kernels import _build
from repro_torch.kernels.ops import unpack_words
from repro_torch.kernels.route_records import (
    PREFIX_BYTES,
    PREFIX_WARPS,
    _kernel_device,
    _require,
    _same_device,
    blocks_per_sm,
    route_plain,
)

I32_MAX = 2**31 - 1
I32_MIN = -(2**31)

# the plan's design, and the launch counters of the kernels it launches
# once a batch each (the leafwise design four)
VARIANTS = {None: 0, "shared": 1, "global": 2, "cluster": 3, "leafwise": 4}
KERNEL_NAMES = _build.FUSED_KERNELS
MAX_WARPS = 32  # csrc/fused_ingest.cu's kMaxWarps: 1024 threads a block
MIN_WARPS = 4  # fewer warps beside the aggregates: the leafwise design
CLUSTER_SIZES = (2, 4, 8, 16)  # 16 past the portable 8, where the card allows
# warps a block the cluster's leaf split is sized by; the block then
# takes as many warps as fit beside its slice
SPLIT_WARPS = 16
# inbox entries a peer warp's lane: csrc/fused_ingest.cu's kInboxShare
INBOX_SHARE = 2
# The leafwise design (csrc/fused_ingest.cu's note): its route kernel's
# block is route_descend_prefix's (PREFIX_WARPS warps' tiles beside the
# tree's BFS prefix in PREFIX_BYTES) plus a 4-byte count a leaf; where two
# such blocks do not fit an SM, one block takes as many warps as fit, at
# most MAX_WARPS.  The plan takes it while PREFIX_WARPS warps fit beside
# the histogram (about 41,000 leaves at 21 columns).  Its fold takes at
# most LEAFWISE_MAX_COLUMNS columns (csrc's kMaxGroups groups of 32) and
# LEAFWISE_MAX_ADV_WORDS words of advanced cuts (a lane's each).
LEAFWISE_MAX_COLUMNS = 256
LEAFWISE_MAX_ADV_WORDS = 32
LEAFWISE_FOLD_WARPS = 8  # csrc's kFoldWarps

# The design the accumulators made under :func:`_forced` take, with the
# cluster kernel's split and the warps a block to force; None chooses by
# shape.  For tests and measurement only.
_FORCED: tuple = (None, None, None, None)


@contextlib.contextmanager
def _forced(variant: Optional[str], cluster: Optional[int] = None,
            ranges: Optional[int] = None, warps: Optional[int] = None):
    """Accumulators made inside take ``variant`` ("shared", "cluster",
    "leafwise" or "global"), the cluster kernel with ``cluster`` blocks a
    cluster and ``ranges`` ranges, and ``warps`` warps a block where
    given; forcing the shared kernel on a tree too large for it, a
    cluster the card refuses or a leafwise shape it cannot run, raises."""
    global _FORCED
    before, _FORCED = _FORCED, (variant, cluster, ranges, warps)
    try:
        yield
    finally:
        _FORCED = before


class Plan(NamedTuple):
    """A launch plan: the design (:data:`VARIANTS`), warps a block,
    dynamic shared bytes, the most blocks (shared, leafwise) or clusters
    (cluster) resident on the card (0 until the card is asked), the
    cluster kernel's blocks a cluster, ranges and leaves a block, and the
    leafwise design's staged nodes (0 otherwise).  The leafwise design's
    warps, bytes and blocks are its route kernel's."""

    kernel: int
    warps: int
    smem: int
    most: int = 0
    cluster: int = 0
    ranges: int = 0
    per_block: int = 0
    prefix: int = 0


def leaf_bytes(shape: tuple) -> int:
    """Shared bytes of one leaf's aggregates: count, lo and hi of every
    column, categorical and advanced-cut words."""
    _, d, cw, aw, _, _ = shape
    return 4 * (1 + 2 * d + cw + 2 * aw)


def table_bytes(shape: tuple) -> int:
    """Shared bytes of the fold's small tables: categorical columns, their
    bit offsets and the advanced cuts' (col_a, op, col_b) rows."""
    _, d, _, _, n_cat, n_adv = shape
    return 4 * (n_cat + d + 3 * n_adv)


def tile_bytes(d: int) -> int:
    """One warp's staging buffer: 32 rows of ``d`` int32 columns."""
    return 4 * 32 * d


def inbox_bytes(cluster: int) -> int:
    """A cluster kernel block's two inboxes, a warp: a 4-byte entry for
    each row its peers' warps may send it in a round, up to INBOX_SHARE a
    lane; rows past a full inbox are folded by their senders."""
    return 2 * 4 * 32 * min(cluster - 1, INBOX_SHARE)


def block_leaves(shape: tuple, optin: int, cluster: int) -> int:
    """Leaves a block of a cluster of ``cluster`` holds beside the warps
    the split is sized by: SPLIT_WARPS, fewer where their tiles would
    take more than half a block's bytes, never fewer than MIN_WARPS, each
    with its tile and its inbox share; and the inboxes' two counts."""
    tile = tile_bytes(shape[1])
    sizing = min(SPLIT_WARPS, max(MIN_WARPS, optin // 2 // tile))
    free = optin - table_bytes(shape) - 8 - sizing * (
        tile + inbox_bytes(cluster))
    return max(1, free // leaf_bytes(shape))


def shared_fixed_bytes(shape: tuple) -> int:
    """The shared kernel's bytes beside its warps' tiles: the whole tree's
    aggregates, the tables and a bit a leaf for the leaves a block's rows
    changed (4 * ceil(L / 32))."""
    L = shape[0]
    return L * leaf_bytes(shape) + table_bytes(shape) + 4 * (-(-L // 32))


def shared_warps_fit(shape: tuple, optin: int) -> int:
    """Warps whose tiles fit beside :func:`shared_fixed_bytes` (at most
    MAX_WARPS, 0 when none does)."""
    return max(0, min(MAX_WARPS, (optin - shared_fixed_bytes(shape))
                      // tile_bytes(shape[1])))


def leafwise_plan(shape: tuple, optin: int,
                  warps: Optional[int] = None) -> Plan:
    """The leafwise design's plan (pure arithmetic): its route kernel
    stages the first nodes of the tree's 2 L - 1 that fit PREFIX_BYTES
    beside PREFIX_WARPS warps' tiles (632 at 21 columns; at least the
    root), and takes PREFIX_WARPS warps where two blocks with the
    histogram fit an SM, else as many as fit one block (at most
    MAX_WARPS, at least one), or ``warps``.  Raises ``ValueError`` past
    the fold's columns or advanced-cut words."""
    L, d, _, aw, _, _ = shape
    if (d > LEAFWISE_MAX_COLUMNS or aw > LEAFWISE_MAX_ADV_WORDS
            or fold_bytes(shape) > optin):
        raise ValueError(
            f"the leafwise fold takes at most {LEAFWISE_MAX_COLUMNS} columns "
            f"and {LEAFWISE_MAX_ADV_WORDS} advanced-cut words, and its "
            f"words a lane fit a block ({fold_bytes(shape)} of {optin} "
            f"bytes); not {d} and {aw}")
    tile = tile_bytes(d)
    prefix = max(1, min(2 * L - 1,
                        (PREFIX_BYTES - PREFIX_WARPS * tile) // 16))
    fixed = 16 * prefix + 4 * L
    if warps is None:
        two = fixed + PREFIX_WARPS * tile
        warps = (PREFIX_WARPS if blocks_per_sm(PREFIX_WARPS, two, optin) >= 2
                 else max(1, min(MAX_WARPS, (optin - fixed) // tile)))
    return Plan(VARIANTS["leafwise"], warps, fixed + warps * tile, 0, 0, 0,
                0, prefix)


def fold_bytes(shape: tuple) -> int:
    """The leafwise fold's shared bytes (csrc's fold_smem): each warp's
    run words and its lanes' categorical and advanced-cut words, and the
    fold's tables."""
    _, d, cw, aw, n_cat, n_adv = shape
    return 4 * (LEAFWISE_FOLD_WARPS * (cw + 32 * (cw + 2 * aw)) + n_cat + d
                + 3 * n_adv)


def leafwise_reaches(shape: tuple, optin: int) -> bool:
    """Does the plan take the leafwise design for a tree of ``shape`` past
    the shared and cluster kernels: its fold takes the columns and the
    advanced cuts, and PREFIX_WARPS warps fit beside the histogram?"""
    try:
        p = leafwise_plan(shape, optin)
    except ValueError:
        return False
    return p.warps >= PREFIX_WARPS and p.smem <= optin


def layout_plan(shape: tuple, optin: int, variant: Optional[str] = None,
                warps: Optional[int] = None, cluster: Optional[int] = None,
                ranges: Optional[int] = None) -> Plan:
    """The launch plan of a tree of ``shape`` (:func:`plan_shape`) on a
    card whose blocks may opt in to ``optin`` shared bytes; ``most`` is
    left 0 for the card to fill.  Pure arithmetic, no card asked.

    ``variant`` None takes the shared kernel when MIN_WARPS warps' tiles
    fit beside the aggregates, else the leafwise design where it reaches
    (:func:`leafwise_reaches`), else the global kernel.  The cluster kernel runs only when forced: on an H100
    the leafwise design beat it on every tree it had been planned on, two
    blocks of 32 warps (PERF.md §6).
    The cluster kernel's leaf split (:func:`block_leaves`) is the smallest
    size of CLUSTER_SIZES whose blocks hold the tree, else the largest in
    the fewest ranges; each block then takes ``warps``, or as many as fit
    beside its slice of ``per_block`` leaves.  ``cluster`` and ``ranges``
    force the split.
    Nothing is clamped to fit: a plan past ``optin`` goes to the card,
    which refuses it.
    """
    L, d = shape[0], shape[1]
    tile = tile_bytes(d)
    fit = shared_warps_fit(shape, optin)
    if variant is None:
        if fit < MIN_WARPS:
            leafwise = leafwise_reaches(shape, optin)
            return layout_plan(shape, optin,
                               "leafwise" if leafwise else "global", warps)
        variant = "shared"
    if variant == "leafwise":
        return leafwise_plan(shape, optin, warps)
    if variant == "global":
        return Plan(VARIANTS["global"], warps or 8, 0)
    if variant == "shared":
        w = warps or max(1, fit)
        return Plan(VARIANTS["shared"], w, shared_fixed_bytes(shape) + w * tile)
    if variant != "cluster":
        raise ValueError(f"unknown fused_ingest variant {variant!r}")
    if cluster is None:
        fits = [c for c in CLUSTER_SIZES
                if c * block_leaves(shape, optin, c) >= L]
        cluster = fits[0] if fits else CLUSTER_SIZES[-1]
    if ranges is None:
        ranges = -(-L // (cluster * block_leaves(shape, optin, cluster)))
    per_block = -(-L // (cluster * ranges))
    # the tables, the slice and the inboxes' two counts
    fixed = table_bytes(shape) + per_block * leaf_bytes(shape) + 8
    per_warp = tile + inbox_bytes(cluster)
    w = warps or max(1, min(MAX_WARPS, (optin - fixed) // per_warp))
    return Plan(VARIANTS["cluster"], w, fixed + w * per_warp, 0, cluster,
                ranges, per_block)


@functools.lru_cache(maxsize=None)
def optin_bytes(index: int) -> int:
    """Shared bytes a block of device ``index`` may opt in to."""
    return int(torch.cuda.get_device_properties(
        index).shared_memory_per_block_optin)


def device_plan(index: int, shape: tuple, variant: Optional[str] = None,
                cluster: Optional[int] = None, ranges: Optional[int] = None,
                warps: Optional[int] = None) -> Plan:
    """:func:`layout_plan` on device ``index``, checked by the card
    (``fused_ingest_plan``), with the most blocks or clusters resident;
    raises ``RuntimeError`` with CUDA's error where the card refuses it."""
    p = layout_plan(shape, optin_bytes(index), variant, warps, cluster,
                    ranges)
    out = _build.plan("fused_ingest", index, p.kernel, p.warps, p.smem,
                      p.cluster, p.ranges, p.per_block, shape[0], shape[1],
                      shape[3], p.prefix)
    return p._replace(most=out[3])


def batches_folded(counts: dict) -> int:
    """Batches folded on the card in a launch count
    (:func:`repro_torch.kernels._build.launch_counts`): each design's
    first kernel runs once a batch."""
    return sum(counts[names[0]] for names in KERNEL_NAMES.values())


class IngestAccumulator:
    """Running per-leaf aggregates of an ingest stream, on one device.

    Allocated once, as one byte buffer, with each field's identity, and
    never re-zeroed: :meth:`fold` adds batch after batch.  Fields (views of
    ``buf``):

    * ``counts`` (L,) int64 records per leaf;
    * ``lo`` / ``hi`` (L, D) int32 column minima / maxima (int32 max / min
      where no record arrived; ``hi`` is the maximum, not max + 1);
    * ``cat`` (L, cw) int32 categorical value bits, bit ``b`` of the bit
      space in word ``b // 32`` at ``b % 32``;
    * ``advt`` / ``advf`` (L, aw) int32 advanced-cut bits: the cut was
      seen true / false.

    The shared kernel's first fold starts its blocks from the identities;
    every later fold from the running aggregates, so that a row writes
    only where it moves them (exact either way: min, max and or move one
    way).
    """

    FIELDS = ("counts", "lo", "hi", "cat", "advt", "advf")

    def __init__(self, ops: dict, launch: Optional[tuple] = None):
        """``launch`` pins the geometry, ``(variant, warps a block, grid
        cap)`` with variant "shared", "cluster", "leafwise" or "global"
        (all but the shared kernel size their own grids, so their cap is
        unused); None plans it by shape.  A pinned geometry the card
        cannot run raises ``ValueError``.  On the CPU the plain version
        runs and the geometry is not used.

        The leafwise design's scratch (leaf ids, the leaf order, the
        batch's per-leaf counts, zero between batches, and their offsets)
        is the accumulator's, one set a CUDA stream, sized to the largest
        batch folded on it: a stream of equal batches allocates nothing.
        """
        self.ops = ops
        dev = ops["cat_off"].device
        L, d = int(ops["n_leaves"]), int(ops["cat_off"].shape[0])
        cw, aw = int(ops["cw"]), int(ops["aw"])
        shapes = {
            "counts": ((L,), torch.int64), "lo": ((L, d), torch.int32),
            "hi": ((L, d), torch.int32), "cat": ((L, cw), torch.int32),
            "advt": ((L, aw), torch.int32), "advf": ((L, aw), torch.int32),
        }
        sizes = [int(np.prod(s)) * t.itemsize for s, t in shapes.values()]
        self.buf = torch.zeros(sum(sizes), dtype=torch.uint8, device=dev)
        self._layout = []
        off = 0
        for (name, (shape, dtype)), n in zip(shapes.items(), sizes):
            setattr(self, name, self.buf[off:off + n].view(dtype).view(shape))
            self._layout.append((name, off, n, shape, dtype))
            off += n
        self.lo.fill_(I32_MAX)
        self.hi.fill_(I32_MIN)
        # the launch's tree and accumulator arguments, checked and packed
        # once: they never change over a stream
        _same_device(dev, "fused_ingest", ops)
        p = _build.ptr
        self._tree_args = (
            p(ops["nodes"]), int(ops["depth"]), p(ops["cat_off"]),
            p(ops["in_mask"]), int(ops["bits"]), p(ops["adv"]),
            p(ops["cat_dims"]), int(ops["cat_dims"].shape[0]),
            int(ops["n_adv"]),
        )
        self._acc_args = (
            *(p(t) for t in self.tensors()), L, cw, aw,
        )
        self._launch = None
        self._seeded = False  # a fold has launched: no longer the identities
        self._scratch: dict[int, dict] = {}  # by stream: leafwise only
        if dev.type == "cuda":
            shape = plan_shape(ops)
            index = torch.cuda.current_device() if dev.index is None \
                else dev.index
            self._launch = (
                device_plan(index, shape, *_FORCED)
                if launch is None else pinned_plan(index, shape, *launch)
            )

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f) for f in self.FIELDS)

    def fold(self, records: torch.Tensor,
             bids: bool = False) -> Optional[torch.Tensor]:
        """Fold one batch in; its (m,) int32 block ids if ``bids``.

        On a CUDA tensor, one launch of each kernel of the plan's design
        (:data:`KERNEL_NAMES`); the plain version only for a tensor on the
        CPU.
        """
        if not _kernel_device(records, "fused_ingest"):
            return fused_ingest_plain(records, self, bids=bids)
        _require(records, torch.int32, "fused_ingest")
        dev = self.buf.device
        if records.dim() != 2 or records.shape[1] != self.lo.shape[1]:
            raise ValueError(
                f"fused_ingest: records of shape {tuple(records.shape)} do "
                f"not match the tree's {self.lo.shape[1]} columns"
            )
        if records.device != dev:
            raise ValueError(
                f"fused_ingest: the accumulator is on {dev}, not "
                f"{records.device}"
            )
        m, d = records.shape
        out = torch.empty(m, dtype=torch.int32, device=dev) if bids else None
        if m == 0:
            return out
        stream = _build.stream_ptr(dev)
        scratch = (None,) * 5
        if self._launch.kernel == VARIANTS["leafwise"]:
            if m > I32_MAX:
                raise ValueError(f"fused_ingest: the leafwise design takes "
                                 f"at most {I32_MAX} rows a batch, not {m}")
            scratch = tuple(_build.ptr(t) for t in
                            self.leafwise_scratch(m, stream).values())
        with tracing.span("fused_ingest.launch"):
            rc = _build.library("fused_ingest").fused_ingest_launch(
                _build.ptr(records), m, d, *self._tree_args,
                _build.ptr(out) if bids else None, *self._acc_args,
                *scratch, *self._launch, int(self._seeded), stream,
            )
        self._seeded = True
        if rc:
            # a stage that did not run may leave the batch's per-leaf
            # counts, which must be zero on entry: the next batch on this
            # stream takes fresh scratch
            self._scratch.pop(stream, None)
        _build.check(rc, "fused_ingest")
        for name in KERNEL_NAMES[self._launch.kernel]:
            _build.count_launch(name)
        return out

    def leafwise_scratch(self, m: int, stream: int) -> dict:
        """The leafwise design's scratch on the stream ``stream`` (its CUDA
        handle), for a batch of ``m`` rows: ``ids`` (m,) int32 (the leaf of
        each row, unless block ids are asked for), ``slots`` (m,) int32
        (each row's place among its leaf's rows), ``entries`` (m,) int64
        (leaf << 32 | row, in leaf order), ``hist`` (L,) int32 (a batch's
        rows a leaf; the scatter zeroes it for the next batch) and
        ``offsets`` (L + 1,) int32 (each leaf's first slot; the last, the
        rows).  Grown to the largest batch, never shrunk."""
        s = self._scratch.get(stream)
        if s is None or s["ids"].shape[0] < m:
            dev, L = self.buf.device, self.lo.shape[0]
            s = {"ids": torch.empty(m, dtype=torch.int32, device=dev),
                 "slots": torch.empty(m, dtype=torch.int32, device=dev),
                 "entries": torch.empty(m, dtype=torch.int64, device=dev),
                 "hist": torch.zeros(L, dtype=torch.int32, device=dev)
                 if s is None else s["hist"],
                 "offsets": torch.empty(L + 1, dtype=torch.int32, device=dev)
                 if s is None else s["offsets"]}
            self._scratch[stream] = s
        return s

    def partial(self, tree: FrozenQdTree) -> TightenPartial:
        """The stream's aggregates in the tightener's exchange format.

        One device-to-host copy.  Empty leaves get the tightener's int64
        identities and ``hi`` becomes exclusive (max + 1): bit-identical
        to ``IncrementalTightener.update`` over every folded record.
        """
        with tracing.span("ingest.partial.copy"):
            host = self.buf.cpu().numpy()
        with tracing.span("ingest.partial.unpack"):
            np_types = {torch.int64: np.int64, torch.int32: np.int32}
            f = {
                name: host[off:off + n].view(np_types[dtype]).reshape(shape)
                for name, off, n, shape, dtype in self._layout
            }
            i64 = np.iinfo(np.int64)
            counts = f["counts"].copy()
            ne = counts > 0
            lo = np.where(ne[:, None], f["lo"].astype(np.int64), i64.max)
            hi = np.where(ne[:, None], f["hi"].astype(np.int64) + 1, i64.min)
            cat = unpack_words(f["cat"], tree.leaf_cat.shape[1]) & ne[:, None]
            adv = np.zeros_like(tree.leaf_adv)
            na = tree.cuts.n_adv
            if na:
                adv[:, :, 0] = unpack_words(f["advt"], na)
                adv[:, :, 1] = unpack_words(f["advf"], na)
                adv &= ne[:, None, None]
            return TightenPartial(counts=counts, lo=lo, hi=hi, cat=cat,
                                  adv=adv)


def plan_shape(ops: dict) -> tuple[int, ...]:
    """The tree's shape as ``fused_ingest_plan`` takes it: leaves, columns,
    categorical and advanced-cut words a leaf, categorical columns and
    advanced cuts."""
    return (int(ops["n_leaves"]), int(ops["cat_off"].shape[0]),
            int(ops["cw"]), int(ops["aw"]), int(ops["cat_dims"].shape[0]),
            int(ops["n_adv"]))


def pinned_plan(index: int, shape: tuple, variant: str, warps: int,
                max_blocks: int) -> Plan:
    """The launch plan of a pinned geometry on device ``index``.

    Checked, never clamped: a geometry the card cannot run raises
    ``ValueError`` with the reason.  The shared kernel's bytes are the
    aggregates plus one 32-row tile a warp; the cluster kernel and the
    leafwise design take only trees whose aggregates do not fit one
    block.  The cluster kernel keeps its plan's cluster size and leaf
    split, and its warps' tiles must fit beside a block's slice; the
    leafwise route's warps' tiles must fit beside its prefix and
    histogram.  The global kernel sizes its own grid.
    """
    if variant not in ("shared", "cluster", "leafwise", "global"):
        raise ValueError(f"variant must be 'shared', 'cluster', 'leafwise' "
                         f"or 'global', not {variant!r}")
    warps, max_blocks = int(warps), int(max_blocks)
    if not 1 <= warps <= MAX_WARPS:
        raise ValueError(f"{warps} warps a block: the kernels take 1 to "
                         f"{MAX_WARPS}")
    if variant == "global":
        return Plan(VARIANTS["global"], warps, 0)
    if variant == "shared" and max_blocks < 1:
        raise ValueError(f"a grid cap of {max_blocks} blocks")
    optin = optin_bytes(index)
    fit = shared_warps_fit(shape, optin)
    if variant in ("cluster", "leafwise"):
        if fit >= MIN_WARPS:
            raise ValueError("the tree's aggregates fit one block's shared "
                             "memory: the shared kernel takes it")
        p = layout_plan(shape, optin, variant, warps)
        if p.smem > optin:
            held = (f"a block's {p.per_block} leaves" if variant == "cluster"
                    else f"{p.prefix} nodes and {shape[0]} leaves' counts")
            raise ValueError(f"{warps} warps do not fit beside {held} "
                             f"({p.smem} of {optin} shared bytes)")
        return device_plan(index, shape, variant, warps=warps)
    if fit < 1:
        raise ValueError("the tree's aggregates do not fit a block's shared "
                         "memory")
    if warps > fit:
        raise ValueError(f"{warps} warps do not fit beside the aggregates: "
                         f"at most {fit} fit a block's shared memory")
    p = device_plan(index, shape, "shared", warps=warps)
    return p._replace(most=max_blocks)


def pack_bits(present: torch.Tensor, n_words: int) -> torch.Tensor:
    """(n, nbits) bool → (n, n_words) int32 words: the torch twin of
    :func:`repro_torch.kernels.ops.pack_words`."""
    n, nbits = present.shape
    full = torch.zeros((n, n_words * 32), dtype=torch.int64,
                       device=present.device)
    full[:, :nbits] = present.to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=present.device)
    weights = weights << torch.arange(32, device=present.device)
    w = (full.view(n, n_words, 32) * weights).sum(dim=2)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def fused_ingest_plain(records: torch.Tensor, acc: IngestAccumulator,
                       bids: bool = True) -> Optional[torch.Tensor]:
    """Route (full predicate matrix, path-constraint form), fold by
    scatters into ``acc``."""
    b32 = route_plain(records, acc.ops)
    acc.counts += torch.bincount(b32.long(), minlength=acc.lo.shape[0])
    fold_plain(records, b32, acc)
    return b32 if bids else None


def fold_plain(records: torch.Tensor, leaf: torch.Tensor,
               acc: IngestAccumulator) -> None:
    """Fold each row of ``records`` into its leaf ``leaf`` (int32) of
    ``acc``: min, max, categorical and advanced-cut words, by scatters; the
    counts are the caller's."""
    ops = acc.ops
    b = leaf.long()
    L, d = acc.lo.shape
    idx = b[:, None].expand(-1, d)
    acc.lo.scatter_reduce_(0, idx, records, "amin")
    acc.hi.scatter_reduce_(0, idx, records, "amax")
    cat_dims = ops["cat_dims"].long()
    if cat_dims.numel():
        nbits = int(ops["bits"])
        pos = records[:, cat_dims] + ops["cat_off"][cat_dims][None, :]
        pos = pos.clamp_(0, nbits - 1).long()
        seen = torch.zeros((L, nbits), dtype=torch.bool, device=b.device)
        seen[b[:, None].expand_as(pos), pos] = True
        acc.cat |= pack_bits(seen, acc.cat.shape[1])
    n_adv = int(ops["n_adv"])
    if n_adv:
        t = adv_truth(records, ops["adv"])[:, :n_adv]
        for flags, truth in ((acc.advt, t), (acc.advf, ~t)):
            rows, cols = truth.nonzero(as_tuple=True)
            seen = torch.zeros((L, n_adv), dtype=torch.bool, device=b.device)
            seen[b[rows], cols] = True
            flags |= pack_bits(seen, flags.shape[1])

