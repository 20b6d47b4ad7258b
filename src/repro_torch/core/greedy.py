"""Greedy top-down qd-tree construction (paper Algorithm 1).

Starting from the singleton tree, repeatedly split any leaf with ≥ 2b
records by the candidate cut maximizing C(T ⊕ (p, n)), subject to both
children having ≥ b records; accept only strict improvements.  Because
C decomposes over leaves, maximizing C(T ⊕ (p,n)) is equivalent to
maximizing the split's own contribution

    |n^p|·skip(n^p) + |n^¬p|·skip(n^¬p)

which we evaluate for *all* candidate cuts of a node in one vectorized
shot: child sizes come from one column-sum over the shared predicate
matrix, and child skip counts from one stacked description↔workload
intersection.

Host numpy, identical to the JAX package's builder: the same sample,
workload and cut table give an array-equal tree.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import predicates as preds
from repro_torch.core import query as qry
from repro_torch.core.qdtree import Node, QdTree, child_descs_all, singleton_tree


@dataclasses.dataclass
class GreedyConfig:
    min_block: int  # b, in *sample* records (caller scales by sample ratio)
    max_leaves: int | None = None
    allow_small_child: bool = False  # overlap extension (paper Sec 6.2)


def _conj_skips(
    descs: dict[str, np.ndarray],
    wt: qry.WorkloadTensors,
    schema,
) -> np.ndarray:
    """(n_cuts,) — number of workload queries skipped by each description."""
    hits = qry.conjuncts_intersect(
        descs["lo"], descs["hi"], descs["cat"], descs["adv"], wt, schema
    )
    q_hits = qry.queries_intersect(hits, wt)
    return wt.n_queries - q_hits.sum(axis=1)


def best_cut_for_node(
    node: Node,
    tree: QdTree,
    cut_matrix: np.ndarray,  # (m_sample, n_cuts) bool, full sample
    wt: qry.WorkloadTensors,
    cfg: GreedyConfig,
) -> tuple[int, float] | None:
    """argmax_p C(T ⊕ (p, n)) over legal cuts; None if no improving cut.

    Returns (cut_id, split_contribution).
    """
    m = node.size
    if m == 0:
        return None
    rows_m = cut_matrix[node.rows]  # (m, n_cuts)
    left_sizes = rows_m.sum(axis=0).astype(np.int64)
    right_sizes = m - left_sizes
    b = cfg.min_block
    if cfg.allow_small_child:
        legal = (
            (left_sizes > 0)
            & (right_sizes > 0)
            & ((left_sizes >= b) | (right_sizes >= b))
        )
    else:
        legal = (left_sizes >= b) & (right_sizes >= b)
    if not legal.any():
        return None

    L, R = child_descs_all(node.desc, tree.cuts)
    skip_l = _conj_skips(L, wt, tree.schema)
    skip_r = _conj_skips(R, wt, tree.schema)
    contrib = left_sizes * skip_l + right_sizes * skip_r
    contrib = np.where(legal, contrib, -1)

    # current contribution of n as a leaf
    parent = {
        "lo": node.desc.lo[None],
        "hi": node.desc.hi[None],
        "cat": node.desc.cat[None],
        "adv": node.desc.adv[None],
    }
    parent_contrib = m * int(_conj_skips(parent, wt, tree.schema)[0])

    best = int(np.argmax(contrib))
    if contrib[best] <= parent_contrib:
        return None
    return best, float(contrib[best])


def build_greedy(
    sample: np.ndarray,
    workload: qry.Workload,
    cuts: preds.CutTable,
    cfg: GreedyConfig,
    verbose: bool = False,
) -> QdTree:
    """Paper Algorithm 1 over a (sampled) record set."""
    schema = workload.schema
    schema.validate_records(sample)
    tree = singleton_tree(
        schema, cuts, sample_rows=np.arange(sample.shape[0])
    )
    cut_matrix = preds.eval_cuts(sample, cuts)
    wt = workload.tensorize(cuts)

    frontier: list[Node] = [tree.root]
    n_leaves = 1
    while frontier:
        if cfg.max_leaves is not None and n_leaves >= cfg.max_leaves:
            break
        node = frontier.pop(0)
        if node.size < 2 * cfg.min_block and not cfg.allow_small_child:
            continue
        choice = best_cut_for_node(node, tree, cut_matrix, wt, cfg)
        if choice is None:
            continue
        cut_id, contrib = choice
        lchild, rchild = tree.split(node, cut_id, cut_matrix=cut_matrix)
        n_leaves += 1
        if verbose:
            print(
                f"greedy: split m={node.size} with "
                f"[{tree.cuts.describe(cut_id)}] -> "
                f"{lchild.size}/{rchild.size} (contrib={contrib:.0f})"
            )
        frontier.append(lchild)
        frontier.append(rchild)
    return tree
