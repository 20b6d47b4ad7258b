"""Batched data routing through a frozen qd-tree (paper Sec 3.1).

Two interchangeable backends, bit-identical:

* ``FrozenQdTree.route``       — numpy oracle (core/qdtree.py)
* engine "torch" backend       — the ``route_descend`` CUDA kernel on
  the GPU, its plain PyTorch version on the CPU

``route`` below is a thin shim over the tree's attached
:class:`~repro_torch.engine.LayoutEngine`.  ``cut_table_arrays`` /
``eval_cuts_torch`` are the predicate evaluation the plain route and
ingest versions build on: integer gathers and compares, with no one-hot
matrix product (TF32 would round codes ≥ 2**11 in one).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import predicates as preds
from repro_torch.core.qdtree import FrozenQdTree


def cut_table_arrays(cuts: preds.CutTable) -> dict[str, np.ndarray]:
    """The cut table as flat int32/uint8 arrays (numpy, host).

    ``dim``/``adv_id`` are clipped at 0 (their -1 entries are never read:
    ``kind`` selects), ``adv`` keeps at least one row so that a device
    buffer always exists, and ``in_mask`` is ``(n_cuts, bits)`` uint8.
    """
    adv = np.zeros((max(cuts.n_adv, 1), 3), np.int32)
    for j, a in enumerate(cuts.adv):
        adv[j] = (a.col_a, a.op, a.col_b)
    return {
        "kind": cuts.kind.astype(np.int32),
        "dim": np.maximum(cuts.dim, 0).astype(np.int32),
        "cutpoint": cuts.cutpoint.astype(np.int32),
        "in_mask": np.ascontiguousarray(cuts.in_mask, dtype=np.uint8),
        "adv_id": np.maximum(cuts.adv_id, 0).astype(np.int32),
        "adv": adv,
        "cat_off": np.maximum(cuts.schema.cat_offsets, 0).astype(np.int32),
    }


def adv_truth(records: torch.Tensor, adv: torch.Tensor) -> torch.Tensor:
    """(m, n_adv_rows) bool truth of each ``col_a op col_b`` predicate.

    Ops 0–4 are <, <=, >, >=, ==; any other op is != (the select default).
    """
    va = records[:, adv[:, 0].long()]
    vb = records[:, adv[:, 2].long()]
    op = adv[:, 1][None, :]
    return torch.where(
        op == preds.OP_LT, va < vb,
        torch.where(
            op == preds.OP_LE, va <= vb,
            torch.where(
                op == preds.OP_GT, va > vb,
                torch.where(
                    op == preds.OP_GE, va >= vb,
                    torch.where(op == preds.OP_EQ, va == vb, va != vb),
                ),
            ),
        ),
    )


def eval_cuts_torch(
    records: torch.Tensor, ca: dict[str, torch.Tensor]
) -> torch.Tensor:
    """(m, n_cuts) uint8 predicate matrix — torch mirror of preds.eval_cuts.

    ``records`` is (m, D) int32; ``ca`` is :func:`cut_table_arrays` as
    tensors on the records' device.
    """
    dim = ca["dim"].long()
    vals = records[:, dim]  # (m, n_cuts) gathered column values
    rng = vals < ca["cutpoint"][None, :]
    # IN: bit lookup at (cut, value + dim offset); gather along the bit
    # axis of the transposed masks, one position column per cut
    in_mask = ca["in_mask"]
    bitpos = (vals + ca["cat_off"][dim][None, :]).clamp_(
        0, in_mask.shape[1] - 1
    )
    inm = torch.gather(in_mask.t(), 0, bitpos.long()) != 0
    advm = adv_truth(records, ca["adv"])[:, ca["adv_id"].long()]
    k = ca["kind"][None, :]
    out = torch.where(
        k == preds.KIND_RANGE, rng,
        torch.where(k == preds.KIND_IN, inm, advm),
    )
    return out.to(torch.uint8)


def route(
    tree: FrozenQdTree, records, backend: str = "torch"
) -> np.ndarray:
    """Route ``records`` on a registered backend (compatibility shim).

    Delegates to the tree's attached :class:`~repro_torch.engine.LayoutEngine`,
    so repeated calls share its cached plans.
    """
    from repro_torch.engine import engine_for

    return engine_for(tree).route(records, backend=backend)
