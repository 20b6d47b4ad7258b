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

On a CUDA tensor ``fold`` launches one of two kernels of
``csrc/fused_ingest.cu``: the shared-memory kernel when the tree's
aggregates fit a block's shared memory, else the global-atomic kernel.
The choice, the warps a block and the grid's cap are planned once a shape
(``_build.plan``), not once a batch, or pinned by the caller (the
autotuner's geometry, ``engine/autotune.py``), checked against the card.
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
from typing import Optional

import numpy as np
import torch

from repro_torch.core.qdtree import FrozenQdTree, TightenPartial
from repro_torch.core.routing import adv_truth
from repro_torch.kernels import _build
from repro_torch.kernels.ops import unpack_words
from repro_torch.kernels.route_records import (
    _kernel_device,
    _require,
    _same_device,
    route_plain,
)

I32_MAX = 2**31 - 1
I32_MIN = -(2**31)

# fused_ingest_plan's ``variant`` argument, and the launch counter each
# kernel moves
VARIANTS = {None: 0, "shared": 1, "global": 2}
KERNEL_NAMES = {1: "fused_ingest_shared", 2: "fused_ingest_global"}
MAX_WARPS = 32  # csrc/fused_ingest.cu's kMaxWarps: 1024 threads a block

# The kernel the accumulators made under :func:`_forced` take; None
# chooses by shape.  For tests and measurement only.
_FORCED: Optional[str] = None


@contextlib.contextmanager
def _forced(variant: Optional[str]):
    """Accumulators made inside take ``variant`` ("shared" or "global");
    forcing the shared kernel on a tree too large for it raises."""
    global _FORCED
    before, _FORCED = _FORCED, variant
    try:
        yield
    finally:
        _FORCED = before


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
    """

    FIELDS = ("counts", "lo", "hi", "cat", "advt", "advf")

    def __init__(self, ops: dict, launch: Optional[tuple] = None):
        """``launch`` pins the geometry, ``(variant, warps a block, grid
        cap)`` with variant "shared" or "global" (the global kernel sizes
        its own grid, so its cap is unused); None plans it by shape.  A
        pinned geometry the card cannot run raises ``ValueError``.  On the
        CPU the plain version runs and the geometry is not used.
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
        if dev.type == "cuda":
            shape = plan_shape(ops)
            index = torch.cuda.current_device() if dev.index is None \
                else dev.index
            self._launch = (
                _build.plan("fused_ingest", index, *shape, VARIANTS[_FORCED])
                if launch is None else pinned_plan(index, shape, *launch)
            )

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f) for f in self.FIELDS)

    def fold(self, records: torch.Tensor,
             bids: bool = False) -> Optional[torch.Tensor]:
        """Fold one batch in; its (m,) int32 block ids if ``bids``.

        One kernel launch on a CUDA tensor; the plain version only for a
        tensor on the CPU.
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
        rc = _build.library("fused_ingest").fused_ingest_launch(
            _build.ptr(records), m, d, *self._tree_args,
            _build.ptr(out) if bids else None, *self._acc_args,
            *self._launch, _build.stream_ptr(dev),
        )
        _build.check(rc, "fused_ingest")
        _build.count_launch(KERNEL_NAMES[self._launch[0]])
        return out

    def partial(self, tree: FrozenQdTree) -> TightenPartial:
        """The stream's aggregates in the tightener's exchange format.

        One device-to-host copy.  Empty leaves get the tightener's int64
        identities and ``hi`` becomes exclusive (max + 1): bit-identical
        to ``IncrementalTightener.update`` over every folded record.
        """
        host = self.buf.cpu().numpy()
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
        return TightenPartial(counts=counts, lo=lo, hi=hi, cat=cat, adv=adv)


def plan_shape(ops: dict) -> tuple[int, ...]:
    """The tree's shape as ``fused_ingest_plan`` takes it: leaves, columns,
    categorical and advanced-cut words a leaf, categorical columns and
    advanced cuts."""
    return (int(ops["n_leaves"]), int(ops["cat_off"].shape[0]),
            int(ops["cw"]), int(ops["aw"]), int(ops["cat_dims"].shape[0]),
            int(ops["n_adv"]))


def pinned_plan(index: int, shape: tuple, variant: str, warps: int,
                max_blocks: int) -> tuple[int, int, int, int]:
    """The launch plan of a pinned geometry on device ``index``.

    Checked, never clamped: a geometry the card cannot run raises
    ``ValueError`` with the reason.  The shared kernel's bytes are the
    aggregates plus one 32-row tile a warp; the shape's own plan
    (``fused_ingest_plan``, forced shared) gives the most warps that fit.
    """
    if variant not in ("shared", "global"):
        raise ValueError(f"variant must be 'shared' or 'global', not "
                         f"{variant!r}")
    warps, max_blocks = int(warps), int(max_blocks)
    if not 1 <= warps <= MAX_WARPS:
        raise ValueError(f"{warps} warps a block: the kernels take 1 to "
                         f"{MAX_WARPS}")
    if variant == "global":
        return (VARIANTS["global"], warps, 0, 0)
    if max_blocks < 1:
        raise ValueError(f"a grid cap of {max_blocks} blocks")
    try:
        kernel, fit, smem, _ = _build.plan("fused_ingest", index, *shape,
                                           VARIANTS["shared"])
    except RuntimeError as exc:
        raise ValueError(f"the tree's aggregates do not fit a block's "
                         f"shared memory ({exc})") from None
    if warps > fit:
        raise ValueError(f"{warps} warps do not fit beside the aggregates: "
                         f"at most {fit} fit a block's shared memory")
    tile = 4 * 32 * shape[1]
    return (kernel, warps, smem - (fit - warps) * tile, max_blocks)


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
    ops = acc.ops
    b32 = route_plain(records, ops)
    b = b32.long()
    L, d = acc.lo.shape
    acc.counts += torch.bincount(b, minlength=L)
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
    return b32 if bids else None

