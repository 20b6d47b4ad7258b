"""The plain reference of the layout path: route rows down a qd-tree's
arrays and fold each leaf's description, in plain PyTorch.

It reads only the layout file's arrays (``FrozenQdTree.to_arrays()``'s
keys) and the rows; it imports nothing of the program, so it works out
everything the program's plan packs for its kernels again:

* route (paper Sec 3.1): each row descends from the root, one level at a
  time, to the left child where the node's cut holds (``row[dim] <
  cutpoint``; ``row[dim]`` in the cut's categorical set; ``row[a] op
  row[b]``), to the right one where it does not;
* fold (Sec 3.2): a leaf's rows, its per-column minimum and maximum + 1,
  the categorical values seen and, per advanced cut, whether it was seen
  true and seen false.

Rows go in blocks (``BLOCK_ROWS``), so the reference fits beside the rows
on the card; the blocks' results merge with min, max and or.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

BLOCK_ROWS = 1 << 22
I64_MAX = torch.iinfo(torch.int64).max
I64_MIN = torch.iinfo(torch.int64).min
KIND_RANGE, KIND_IN, KIND_ADV = 0, 1, 2
# the advanced cuts' operators, by code: <, <=, >, >=, ==, !=
OPS = (torch.lt, torch.le, torch.gt, torch.ge, torch.eq, torch.ne)


def pick(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` along the first axis."""
    return table.index_select(0, idx)


class Layout:
    """A layout file's arrays as tensors on ``device``."""

    def __init__(self, arrays: dict, device):
        dev = torch.device(device)

        def t(key, dtype=torch.int64):
            return torch.as_tensor(np.asarray(arrays[key]), device=dev).to(
                dtype)

        self.device = dev
        self.cut_id, self.left, self.right = (t("cut_id"), t("left"),
                                              t("right"))
        self.leaf_bid = t("leaf_bid")
        self.depth = int(arrays["depth"])
        self.kind, self.dim = t("ct_kind"), t("ct_dim")
        self.cutpoint = t("ct_cutpoint")
        self.in_mask = t("ct_in_mask", torch.bool)
        self.adv_id = t("ct_adv_id")
        adv = np.asarray(arrays["ct_adv"]).reshape(-1, 3)
        self.adv = [tuple(int(x) for x in row) for row in adv]
        cols = json.loads(str(arrays["schema"]))
        offsets, pos = [], 0
        for _, kind, dom in cols:
            offsets.append(pos if kind == "categorical" else -1)
            pos += int(dom) if kind == "categorical" else 0
        self.cat_dims = [d for d, o in enumerate(offsets) if o >= 0]
        self.cat_off = torch.tensor(offsets, device=dev)
        self.bits = pos
        self.n_leaves = int(np.asarray(arrays["leaf_lo"]).shape[0])
        self.ndims = len(cols)
        adv_a = torch.tensor([a for a, _, _ in self.adv] or [0], device=dev)
        adv_b = torch.tensor([b for _, _, b in self.adv] or [0], device=dev)
        adv_op = torch.tensor([o for _, o, _ in self.adv] or [0], device=dev)
        ids = self.adv_id.clamp(min=0)
        self.cut_a, self.cut_b = pick(adv_a, ids), pick(adv_b, ids)
        self.cut_op = pick(adv_op, ids)

    def holds(self, rows: torch.Tensor, cut: torch.Tensor) -> torch.Tensor:
        """Whether each row satisfies the cut ``cut[r]`` (a valid id)."""

        def column(cols):
            return rows.gather(1, cols[:, None]).squeeze(1).long()

        kind = pick(self.kind, cut)
        dim = pick(self.dim, cut).clamp(min=0)
        value = column(dim)
        below = value < pick(self.cutpoint, cut)
        width = self.in_mask.shape[1]
        bit = (pick(self.cat_off, dim) + value).clamp(0, width - 1)
        member = pick(self.in_mask.reshape(-1), cut * width + bit)
        a = column(pick(self.cut_a, cut))
        b = column(pick(self.cut_b, cut))
        op = pick(self.cut_op, cut)
        adv = torch.zeros_like(below)
        for code, fn in enumerate(OPS):
            adv |= (op == code) & fn(a, b)
        return torch.where(kind == KIND_RANGE, below,
                           torch.where(kind == KIND_IN, member, adv))

    def route(self, rows: torch.Tensor) -> torch.Tensor:
        """(m,) int64 block id of each row."""
        node = torch.zeros(rows.shape[0], dtype=torch.int64,
                           device=rows.device)
        for _ in range(self.depth):
            cut = pick(self.cut_id, node)
            inner = cut >= 0
            if not bool(inner.any()):
                break
            go_left = self.holds(rows, cut.clamp(min=0))
            nxt = torch.where(go_left, pick(self.left, node),
                              pick(self.right, node))
            node = torch.where(inner, nxt, node)
        return pick(self.leaf_bid, node)


@dataclasses.dataclass
class Fold:
    """Per-leaf aggregates, identities where a leaf saw no row."""

    counts: torch.Tensor  # (L,) int64
    lo: torch.Tensor  # (L, D) int64 minima
    hi: torch.Tensor  # (L, D) int64 maxima + 1
    cat: torch.Tensor  # (L, bits) bool
    adv: torch.Tensor  # (L, A, 2) bool: seen true, seen false

    @staticmethod
    def empty(layout: Layout) -> "Fold":
        L, d, dev = layout.n_leaves, layout.ndims, layout.device
        return Fold(
            counts=torch.zeros(L, dtype=torch.int64, device=dev),
            lo=torch.full((L, d), I64_MAX, dtype=torch.int64, device=dev),
            hi=torch.full((L, d), I64_MIN, dtype=torch.int64, device=dev),
            cat=torch.zeros((L, layout.bits), dtype=torch.bool, device=dev),
            adv=torch.zeros((L, len(layout.adv), 2), dtype=torch.bool,
                            device=dev),
        )

    def add(self, layout: Layout, rows: torch.Tensor,
            bids: torch.Tensor) -> None:
        """Fold ``rows``, routed to ``bids``, in."""
        L = layout.n_leaves
        v = rows.long()
        self.counts += torch.bincount(bids, minlength=L)
        idx = bids[:, None].expand_as(v)
        self.lo.scatter_reduce_(0, idx, v, "amin")
        self.hi.scatter_reduce_(0, idx, v + 1, "amax")
        flat = self.cat.view(-1)
        for d in layout.cat_dims:
            flat.index_fill_(
                0, bids * layout.bits + int(layout.cat_off[d]) + v[:, d],
                True)
        advf = self.adv.view(-1)
        n_adv = len(layout.adv)
        for j, (a, op, b) in enumerate(layout.adv):
            # slot 0: the cut was seen true, slot 1: seen false
            slot = (~OPS[op](v[:, a], v[:, b])).long()
            advf.index_fill_(0, (bids * n_adv + j) * 2 + slot, True)

    def merged(self, other: "Fold") -> "Fold":
        """The fold of both folds' rows."""
        return Fold(counts=self.counts + other.counts,
                    lo=torch.minimum(self.lo, other.lo),
                    hi=torch.maximum(self.hi, other.hi),
                    cat=self.cat | other.cat, adv=self.adv | other.adv)

    def described(self) -> dict:
        """The leaf descriptions this fold gives (the tree's ``leaf_lo``,
        ``leaf_hi``, ``leaf_cat`` and ``leaf_adv`` after tightening): empty
        leaves get zeros and no bits."""
        ne = self.counts > 0
        return {
            "leaf_lo": torch.where(ne[:, None], self.lo, 0),
            "leaf_hi": torch.where(ne[:, None], self.hi, 0),
            "leaf_cat": self.cat & ne[:, None],
            "leaf_adv": self.adv & ne[:, None, None],
        }


def route_and_fold(layout: Layout, rows: torch.Tensor, head_rows: int,
                   batch_rows: int):
    """The folds of ``rows[:head_rows]`` and of the rest, and the leaves
    each batch of ``batch_rows`` rows touches, a block of BLOCK_ROWS rows
    at a time."""
    head, tail = Fold.empty(layout), Fold.empty(layout)
    n, L = int(rows.shape[0]), layout.n_leaves
    n_batches = -(-n // batch_rows)
    touched = torch.zeros(n_batches * L, dtype=torch.bool,
                          device=layout.device)
    for s in range(0, n, BLOCK_ROWS):
        block = rows[s:s + BLOCK_ROWS].to(layout.device)
        b = layout.route(block)
        at = torch.arange(s, s + block.shape[0], device=layout.device)
        touched[(at // batch_rows) * L + b] = True
        cut = min(max(head_rows - s, 0), block.shape[0])
        if cut:
            head.add(layout, block[:cut], b[:cut])
        if cut < block.shape[0]:
            tail.add(layout, block[cut:], b[cut:])
    return head, tail, touched.view(n_batches, L).sum(dim=1)
