"""Batched record routing (paper Sec 3.1): ``route``, ``eval_cuts`` and
``locate_leaf``.

``route`` maps records to block ids in one launch of ``route_descend``
(``csrc/route_descend.cu``): each record descends the packed nodes, and
no predicate matrix is built.  ``eval_cuts`` (the predicate matrix) and
``locate_leaf`` (block ids from it) are the port's counterparts of the
reference's two Pallas kernels, whose composition ``route`` computes;
its plain version is that composition.  Each function has two CUDA
kernels, one that stages its tiles in shared memory and one that reads
global memory, chosen by shape in a launch plan made once a shape, and a
plain PyTorch version beside them.  The wrapper launches a kernel for a
CUDA tensor and raises if the launch fails; it takes the plain version
only for a tensor on the CPU.

``ops`` is the dict of route operands from
:func:`repro_torch.engine.plan.pack_route_constants`, uploaded to the
records' device (:func:`repro_torch.engine.plan.to_device`);
``eval_cuts`` needs only :func:`repro_torch.engine.plan.pack_cut_table`.
"""

from __future__ import annotations

# qdlint: deterministic-module

import contextlib
from typing import Optional

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
# the ``variant`` argument of the plan functions; each function's two
# kernels move its one launch counter
VARIANTS = {None: 0, "shared": 1, "global": 2}

# The kernel that plans made under :func:`_forced` take; None chooses by
# shape.  For tests and measurement only.
_FORCED: Optional[str] = None


@contextlib.contextmanager
def _forced(variant: Optional[str]):
    """Plans made inside take ``variant`` ("shared" or "global"); forcing
    the shared kernel on a shape too large for it raises."""
    global _FORCED
    before, _FORCED = _FORCED, variant
    try:
        yield
    finally:
        _FORCED = before


def _plan(name: str, t: torch.Tensor, *shape: int) -> tuple:
    """``<name>_plan``'s launch plan for ``shape`` on ``t``'s CUDA device:
    (kernel, warps a block, shared bytes, most blocks), made once a shape
    and variant (:func:`repro_torch.kernels._build.plan`)."""
    index = torch.cuda.current_device() if t.device.index is None \
        else t.device.index
    return _build.plan(name, index, *shape, VARIANTS[_FORCED])


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
def route_plan(ops: dict) -> tuple:
    """route_descend's launch plan for the tree of ``ops`` (on a CUDA
    device): (kernel, warps a block, shared bytes, most blocks), made once
    a tree shape.  The engine keeps it in its tree plan as
    ``ops["route_plan"]``, so a batch makes no host query of the card."""
    return _plan("route_descend", ops["nodes"], int(ops["nodes"].shape[0]),
                 int(ops["cat_off"].shape[0]))


def route_plain(records: torch.Tensor, ops: dict) -> torch.Tensor:
    """(m,) int32 block ids in the reference's design: the predicate
    matrix, then leaves in path-constraint form."""
    return locate_leaf_plain(eval_cuts_plain(records, ops), ops)


def route(records: torch.Tensor, ops: dict) -> torch.Tensor:
    """(m,) int32 block id of each record: one ``route_descend`` launch
    on a CUDA tensor, with the plan ``ops["route_plan"]`` where the
    engine made one."""
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
    _build.count_launch("route_descend")
    return out
