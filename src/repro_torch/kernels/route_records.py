"""Batched record routing (paper Sec 3.1): ``route``, ``eval_cuts`` and
``locate_leaf``.

``route`` maps records to block ids in one launch of ``route_descend``
(``csrc/route_descend.cu``): each record descends the packed nodes, and
no predicate matrix is built.  ``eval_cuts`` (the predicate matrix) and
``locate_leaf`` (block ids from it) are the port's counterparts of the
reference's two Pallas kernels, whose composition ``route`` computes;
its plain version is that composition.  ``eval_cuts`` and
``locate_leaf`` have two CUDA kernels each, one that stages its tiles in
shared memory and one that reads global memory, chosen by shape in a
launch plan made once a shape.  ``route`` has three: the whole tree in
shared memory, the tree's BFS prefix in shared memory and the deeper
levels through L1 and L2 (for trees the first would hold only beside
fewer warps, and past 7,000 nodes), and one thread a record over global
memory (forced only);
:func:`descend_plan` chooses by shape, in arithmetic, and the card
checks it.  Each function has a plain PyTorch version beside its
kernels.  The wrapper launches a kernel for a CUDA tensor and raises if
the launch fails; it takes the plain version only for a tensor on the
CPU.

``ops`` is the dict of route operands from
:func:`repro_torch.engine.plan.pack_route_constants`, uploaded to the
records' device (:func:`repro_torch.engine.plan.to_device`);
``eval_cuts`` needs only :func:`repro_torch.engine.plan.pack_cut_table`.
"""

from __future__ import annotations

# qdlint: deterministic-module

import contextlib
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.core.routing import eval_cuts_torch
from repro_torch.kernels import _build


def _kernel_device(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def _require(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor, got "
            f"{t.dtype} (contiguous={t.is_contiguous()})"
        )


def _same_device(device: torch.device, name: str, *operands: dict) -> None:
    """Raise unless every tensor operand lies on ``device``: the kernel
    dereferences their pointers there."""
    for ops in operands:
        for k, v in ops.items():
            if isinstance(v, torch.Tensor) and v.device != device:
                raise ValueError(
                    f"{name}: operand {k!r} is on {v.device}, not {device}"
                )


def _require_records(records: torch.Tensor, ops: dict, name: str) -> None:
    """A contiguous int32 (m, D) batch whose width matches the cut table."""
    _require(records, torch.int32, name)
    if records.dim() != 2 or records.shape[1] != ops["cat_off"].shape[0]:
        raise ValueError(
            f"{name}: records of shape {tuple(records.shape)} do not match "
            f"the tree's {ops['cat_off'].shape[0]} columns"
        )
    _same_device(records.device, name, ops)


# ---------------------------------------------------------------------------
# launch plans: the kernel of each function is chosen by shape
# ---------------------------------------------------------------------------
# the ``variant`` argument of the plan functions: eval_cuts' and
# locate_leaf's two kernels move their function's one launch counter;
# route_descend's three ("prefix" is route's alone) count apart
VARIANTS = {None: 0, "shared": 1, "global": 2, "prefix": 3}
ROUTE_KERNELS = _build.ROUTE_KERNELS  # route_descend's kernel by plan id

# The kernel that plans made under :func:`_forced` take, with route's warps
# a block and staged nodes where given; None chooses by shape.  For tests
# and measurement only.
_FORCED: tuple = (None, None, None)


@contextlib.contextmanager
def _forced(variant: Optional[str], warps: Optional[int] = None,
            prefix: Optional[int] = None):
    """Plans made inside take ``variant`` ("shared" or "global"; route also
    "prefix"), route's at ``warps`` a block and ``prefix`` staged nodes
    where given.  Forcing a kernel on a shape too large for it raises."""
    global _FORCED
    before, _FORCED = _FORCED, (variant, warps, prefix)
    try:
        yield
    finally:
        _FORCED = before


def _plan(name: str, t: torch.Tensor, *shape: int) -> tuple:
    """``<name>_plan``'s launch plan for ``shape`` on ``t``'s CUDA device:
    (kernel, warps a block, shared bytes, most blocks), made once a shape
    and variant (:func:`repro_torch.kernels._build.plan`)."""
    if _FORCED[0] == "prefix":
        raise ValueError(f"{name}: the prefix kernel is route_descend's")
    return _build.plan(name, _index(t), *shape, VARIANTS[_FORCED[0]])


def _index(t: torch.Tensor) -> int:
    return torch.cuda.current_device() if t.device.index is None \
        else t.device.index


# ---------------------------------------------------------------------------
# eval_cuts
# ---------------------------------------------------------------------------
def eval_cuts_plain(records: torch.Tensor, ops: dict) -> torch.Tensor:
    """(m, n_cuts) uint8 predicate matrix by gathers and compares."""
    return eval_cuts_torch(records, ops)


def eval_cuts_plan(ops: dict) -> tuple:
    """eval_cuts's launch plan for the cut table of ``ops`` (on a CUDA
    device), by its cut count, the records' width and the IN bits."""
    return _plan("eval_cuts", ops["cut_pack"], int(ops["cut_pack"].shape[0]),
                 int(ops["cat_off"].shape[0]), int(ops["in_mask"].shape[1]))


def eval_cuts(records: torch.Tensor, ops: dict) -> torch.Tensor:
    """(m, n_cuts) uint8: 1 iff record r satisfies cut c.  On a CUDA
    tensor one ``eval_cuts`` launch over ``ops["cut_pack"]`` and
    ``ops["in_mask"]``."""
    if not _kernel_device(records, "eval_cuts"):
        return eval_cuts_plain(records, ops)
    _require_records(records, ops, "eval_cuts")
    m, d = records.shape
    n_cuts = int(ops["cut_pack"].shape[0])
    out = torch.empty((m, n_cuts), dtype=torch.uint8, device=records.device)
    if m == 0 or n_cuts == 0:
        return out
    fn = _build.library("eval_cuts").eval_cuts_launch
    p = _build.ptr
    rc = fn(
        p(records), m, d, p(ops["cut_pack"]), n_cuts, p(ops["in_mask"]),
        int(ops["in_mask"].shape[1]), p(out), *eval_cuts_plan(ops),
        _build.stream_ptr(records.device),
    )
    _build.check(rc, "eval_cuts")
    _build.count_launch("eval_cuts")
    return out


# ---------------------------------------------------------------------------
# locate_leaf
# ---------------------------------------------------------------------------
LOCATE_CHUNK = 1 << 16  # rows per path-constraint product in the plain form


def locate_leaf_plain(m_mat: torch.Tensor, ops: dict) -> torch.Tensor:
    """(m,) int32 block ids in path-constraint form.

    ``viol = (1 - M) @ PathPos + M @ PathNeg`` counts, per record and leaf,
    the constraints of the leaf's root path the record breaks; the unique
    leaf with none is the record's.  The products are over 0/1 values with
    sums below 2**24, exact in float32 (and in TF32, whose inputs here are
    exactly 0 or 1).  Rows go in chunks to bound the (rows, n_leaves)
    intermediates.
    """
    pos, neg = ops["pathpos"], ops["pathneg"]
    leafid = torch.arange(
        1, pos.shape[1] + 1, dtype=torch.int64, device=m_mat.device
    )
    out = torch.empty(m_mat.shape[0], dtype=torch.int32, device=m_mat.device)
    for s in range(0, m_mat.shape[0], LOCATE_CHUNK):
        mf = m_mat[s:s + LOCATE_CHUNK].to(torch.float32)
        viol = (1.0 - mf) @ pos + mf @ neg
        hit = (viol < 0.5).to(torch.int64)
        out[s:s + LOCATE_CHUNK] = ((hit * leafid).sum(1) - 1).to(torch.int32)
    return out


def locate_leaf_plan(ops: dict) -> tuple:
    """locate_leaf's launch plan for the tree of ``ops`` (on a CUDA
    device), by its node and cut counts."""
    return _plan("locate_leaf", ops["cut_id"], int(ops["cut_id"].shape[0]),
                 int(ops["cut_pack"].shape[0]))


def locate_leaf(m_mat: torch.Tensor, ops: dict) -> torch.Tensor:
    """(m,) int32 block id of each record from its predicate-matrix row."""
    if not _kernel_device(m_mat, "locate_leaf"):
        return locate_leaf_plain(m_mat, ops)
    _require(m_mat, torch.uint8, "locate_leaf")
    m, n_cuts = m_mat.shape
    if n_cuts != ops["cut_pack"].shape[0]:
        raise ValueError("locate_leaf: predicate matrix width != n_cuts")
    _same_device(m_mat.device, "locate_leaf", ops)
    out = torch.empty(m, dtype=torch.int32, device=m_mat.device)
    if m == 0:
        return out
    fn = _build.library("locate_leaf").locate_leaf_launch
    p = _build.ptr
    rc = fn(
        p(m_mat), m, n_cuts, p(ops["cut_id"]), p(ops["left"]),
        p(ops["right"]), p(ops["leaf_bid"]), int(ops["cut_id"].shape[0]),
        int(ops["depth"]), p(out), *locate_leaf_plan(ops),
        _build.stream_ptr(m_mat.device),
    )
    _build.check(rc, "locate_leaf")
    _build.count_launch("locate_leaf")
    return out


# ---------------------------------------------------------------------------
# route: one descent a record (route_descend)
# ---------------------------------------------------------------------------
MAX_WARPS = 32  # csrc/route_descend.cu's kMaxWarps: 1024 threads a block
MIN_WARPS = 4  # fewer warps a block: the next kernel
GLOBAL_WARPS = 8  # the global kernel's 256 threads a block
# The shared kernel where its plan fills blocks of MAX_WARPS warps and the
# tree has at most SHARED_MAX_NODES nodes, else the prefix kernel: PREFIX_WARPS
# warps a block and PREFIX_BYTES of dynamic shared memory, its tiles and as
# many nodes as fit beside them (632 at 21 columns).  At 38 registers a
# thread an SM holds two such blocks, which with their reserves take 132 KB
# of its 256 KB of shared memory and L1, leaving L1 124 KB for the deeper
# levels and in_mask.  The crossover and the shape were measured on an H100
# (PERF.md §6): fewer warps, a larger prefix or a smaller L1 were slower.
SHARED_MAX_NODES = 7_000
PREFIX_WARPS = 21
PREFIX_BYTES = 66_560
# what an SM holds (an H100's): 2,048 threads, 32 blocks, and a block's
# opt-in shared bytes plus this many reserved a block (233,472 in all)
SM_THREADS = 2048
SM_BLOCKS = 32
RESERVED_BYTES = 1024


class RoutePlan(NamedTuple):
    """route_descend's launch plan: the kernel (:data:`VARIANTS`), warps a
    block, dynamic shared bytes, the most blocks resident on the card (0
    until the card is asked), and the nodes the prefix kernel stages (0
    otherwise)."""

    kernel: int
    warps: int
    smem: int
    most: int = 0
    prefix: int = 0


def tile_bytes(d: int) -> int:
    """One warp's staging buffer: 32 rows of ``d`` int32 columns."""
    return 4 * 32 * d


def blocks_per_sm(warps: int, smem: int, optin: int) -> int:
    """Blocks of ``warps`` warps and ``smem`` dynamic shared bytes one SM
    holds, by its threads, its blocks and its shared bytes.  The shared
    kernel's launch bounds leave registers for all of them; the prefix
    kernel's registers allow fewer, which the card reports (``most``)."""
    return min(SM_THREADS // (32 * warps), SM_BLOCKS,
               (optin + RESERVED_BYTES) // (smem + RESERVED_BYTES))


def shared_fit(n_nodes: int, d: int, optin: int) -> int:
    """Warps whose tiles fit beside the whole tree in one block (at most
    MAX_WARPS, 0 when none does)."""
    return max(0, min(MAX_WARPS, (optin - 16 * n_nodes) // tile_bytes(d)))


def descend_plan(n_nodes: int, d: int, optin: int,
                 variant: Optional[str] = None, warps: Optional[int] = None,
                 prefix: Optional[int] = None) -> RoutePlan:
    """route_descend's launch plan for a tree of ``n_nodes`` nodes and
    records of ``d`` columns, on a card whose blocks may opt in to
    ``optin`` shared bytes; ``most`` is left 0 for the card to fill.  Pure
    arithmetic, no card asked.

    ``variant`` None takes the shared kernel where its plan fills blocks of
    MAX_WARPS warps and the tree has at most SHARED_MAX_NODES nodes, else
    the prefix kernel where MIN_WARPS warps' tiles fit beside the root,
    else the global kernel.  The shared kernel takes the warps a block
    that put the most warps on an SM, the larger on a tie.  The prefix
    kernel takes PREFIX_WARPS warps a block and stages as many nodes as fit
    beside their tiles in PREFIX_BYTES, at most the tree; where not even
    MIN_WARPS warps' tiles (or the ``warps`` forced) fit there, as many
    warps (at most PREFIX_WARPS) and nodes as fit ``optin``.  ``warps``
    and ``prefix`` force those.  A prefix kernel without room for one
    warp's tile and the root, or asked to stage more nodes than the tree
    has or none, raises ``ValueError``; a shared plan past ``optin`` goes
    to the card, which refuses it.
    """
    tile = tile_bytes(d)
    fit = shared_fit(n_nodes, d, optin)
    room = min(PREFIX_BYTES, optin)
    if (warps or MIN_WARPS) * tile + 16 > room:
        room = optin
    prefix_warps = min(PREFIX_WARPS, (room - 16) // tile)
    if variant is None:
        shared = descend_plan(n_nodes, d, optin, "shared")
        variant = ("shared" if shared.warps == MAX_WARPS
                   and n_nodes <= SHARED_MAX_NODES
                   else "prefix" if prefix_warps >= MIN_WARPS else "global")
    if variant == "global":
        return RoutePlan(VARIANTS["global"], warps or GLOBAL_WARPS, 0)
    if variant == "shared":
        if warps is None:
            best = (0, 1)  # (warps on an SM, warps a block)
            for w in range(1, fit + 1):
                per = blocks_per_sm(w, 16 * n_nodes + w * tile, optin)
                best = max(best, (w * per, w))
            warps = best[1]
        return RoutePlan(VARIANTS["shared"], warps,
                         16 * n_nodes + warps * tile)
    if variant != "prefix":
        raise ValueError(f"unknown route_descend variant {variant!r}")
    warps = warps or prefix_warps
    if warps < 1 or 16 + warps * tile > room:
        raise ValueError(
            f"route_descend_prefix: {max(warps, 1)} warps' tiles of {d} "
            f"columns and the root do not fit {optin} shared bytes")
    k = prefix or min(n_nodes, (room - warps * tile) // 16)
    if not 1 <= k <= n_nodes:
        raise ValueError(f"route_descend_prefix: cannot stage {k} of "
                         f"{n_nodes} nodes")
    return RoutePlan(VARIANTS["prefix"], warps, 16 * k + warps * tile, 0, k)


@functools.lru_cache(maxsize=None)
def optin_bytes(index: int) -> int:
    """Shared bytes a block of device ``index`` may opt in to."""
    return int(torch.cuda.get_device_properties(
        index).shared_memory_per_block_optin)


def route_plan(ops: dict) -> RoutePlan:
    """route_descend's launch plan for the tree of ``ops`` (on a CUDA
    device): :func:`descend_plan` (or the kernel :func:`_forced`), checked
    by the card (``route_descend_plan``), with the most blocks resident;
    raises ``RuntimeError`` with CUDA's error where the card refuses it.
    Made once a tree shape: the engine keeps it in its tree plan as
    ``ops["route_plan"]``, so a batch makes no host query of the card."""
    index = _index(ops["nodes"])
    n_nodes, d = int(ops["nodes"].shape[0]), int(ops["cat_off"].shape[0])
    p = descend_plan(n_nodes, d, optin_bytes(index), *_FORCED)
    out = _build.plan("route_descend", index, n_nodes, d, p.kernel, p.warps,
                      p.smem, p.prefix)
    return p._replace(most=out[3])


def route_plain(records: torch.Tensor, ops: dict) -> torch.Tensor:
    """(m,) int32 block ids in the reference's design: the predicate
    matrix, then leaves in path-constraint form."""
    return locate_leaf_plain(eval_cuts_plain(records, ops), ops)


def route(records: torch.Tensor, ops: dict) -> torch.Tensor:
    """(m,) int32 block id of each record: on a CUDA tensor one launch of
    the kernel of the plan ``ops["route_plan"]`` where the engine made one,
    else of :func:`route_plan`."""
    on_card = _kernel_device(records, "route_descend")
    _require_records(records, ops, "route_descend")
    if not on_card:
        return route_plain(records, ops)
    m, d = records.shape
    out = torch.empty(m, dtype=torch.int32, device=records.device)
    if m == 0:
        return out
    plan = ops.get("route_plan") or route_plan(ops)
    fn = _build.library("route_descend").route_descend_launch
    p = _build.ptr
    rc = fn(
        p(records), m, d, p(ops["nodes"]), int(ops["nodes"].shape[0]),
        int(ops["depth"]), p(ops["in_mask"]), int(ops["in_mask"].shape[1]),
        p(out), *plan, _build.stream_ptr(records.device),
    )
    _build.check(rc, "route_descend")
    _build.count_launch(ROUTE_KERNELS[plan[0]])
    return out
