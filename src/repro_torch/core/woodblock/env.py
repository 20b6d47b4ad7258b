"""Tree-construction MDP (paper Sec 5.2).

State space: subspaces of the data space (tree nodes).  Action space: the
candidate cut set.  Taking a cut on a node produces two child states pushed
onto an exploration queue; a node with no *legal* cut (both children would
need ≥ s·b sample records, Sec 5.2.1) becomes a leaf.  An episode builds one
complete qd-tree; rewards are computed afterwards (Sec 5.2.2).

The sample's (m, n_cuts) cut matrix is evaluated once, at construction: on
a GPU by one launch of the ``eval_cuts`` kernel
(``kernels/route_records.py``, ``csrc/eval_cuts.cu``), copied back once
into pinned memory; with ``device="cpu"`` by its plain PyTorch version.
Episodes are host numpy over that matrix.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import predicates as preds
from repro_torch.core import query as qry
from repro_torch.core import rewards as rw
from repro_torch.core.qdtree import Node, QdTree, singleton_tree
from repro_torch.core.woodblock.featurize import Featurizer
from repro_torch.engine import plan as planlib
from repro_torch.kernels import route_records as rk


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array.  A CUDA tensor comes back by one copy into a
    fresh pinned host tensor, on the current stream, then a sync of that
    stream; the array's base keeps the pinned tensor alive."""
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host.numpy()


def cut_matrix(
    sample: np.ndarray, cuts: preds.CutTable, device: torch.device
) -> np.ndarray:
    """(m, n_cuts) bool: ``preds.eval_cuts`` by one ``eval_cuts`` launch on
    a GPU device (the plain version on the CPU), copied back once
    (:func:`to_host`).  The operands are ``plan.pack_cut_table``'s, as
    ``plan.pack_route_constants`` packs a tree's."""
    ops = planlib.to_device(planlib.pack_cut_table(cuts), device)
    rec = torch.from_numpy(np.ascontiguousarray(sample, np.int32)).to(device)
    return to_host(rk.eval_cuts(rec, ops).view(torch.bool))


@dataclasses.dataclass
class Transition:
    state: np.ndarray  # featurized node
    legal: np.ndarray  # (n_cuts,) bool
    action: int
    logp: float
    value: float
    node_key: int  # id(node) for reward lookup after the episode
    reward: float = 0.0


@dataclasses.dataclass
class EpisodeResult:
    tree: QdTree
    transitions: list[Transition]
    scanned_fraction: float  # on the construction sample


class TreeEnv:
    """One environment instance; episodes share the fixed data sample."""

    def __init__(
        self,
        sample: np.ndarray,
        workload: qry.Workload,
        cuts: preds.CutTable,
        min_block_sample: int,
        allow_small_child: bool = False,
        max_leaves: int | None = None,
        device=None,
    ):
        self.device = planlib.resolve_device(device)
        self.schema = workload.schema
        # one gather of a strided sample (a view such as records[::100]),
        # so the check, the upload and the episodes read contiguous rows
        sample = np.ascontiguousarray(sample)
        self.schema.validate_records(sample)
        self.sample = sample
        self.workload = workload
        self.cuts = cuts
        self.b = max(1, min_block_sample)
        self.allow_small_child = allow_small_child
        self.max_leaves = max_leaves
        self.cut_matrix = cut_matrix(sample, cuts, self.device)
        self.wt = workload.tensorize(cuts)
        self.featurizer = Featurizer(self.schema, cuts.n_adv)

    @property
    def n_actions(self) -> int:
        return self.cuts.n_cuts

    @property
    def feature_dim(self) -> int:
        return self.featurizer.dim

    # -- legality (stopping condition, Sec 5.2.1) ---------------------------
    def legal_actions(self, node: Node) -> np.ndarray:
        if node.size < (self.b if self.allow_small_child else 2 * self.b):
            return np.zeros(self.n_actions, bool)
        left = self.cut_matrix[node.rows].sum(axis=0)
        right = node.size - left
        if self.allow_small_child:
            return (left > 0) & (right > 0) & (
                (left >= self.b) | (right >= self.b)
            )
        return (left >= self.b) & (right >= self.b)

    # -- episode -------------------------------------------------------------
    def run_episode(self, policy_fn, rng: np.random.Generator) -> EpisodeResult:
        """Build one tree.  ``policy_fn(states, legal) -> (actions, logps,
        values)`` is the (batched) agent; we expand the queue level by level
        so network evaluation is batched."""
        tree = singleton_tree(
            self.schema, self.cuts, sample_rows=np.arange(self.sample.shape[0])
        )
        transitions: list[Transition] = []
        queue: list[tuple[Node, np.ndarray]] = []
        legal0 = self.legal_actions(tree.root)
        n_leaves = 1
        if legal0.any():
            queue.append((tree.root, legal0))
        while queue:
            if self.max_leaves is not None and n_leaves >= self.max_leaves:
                break
            nodes = [n for n, _ in queue]
            legals = np.stack([l for _, l in queue])
            states = self.featurizer.batch([n.desc for n in nodes])
            queue = []
            actions, logps, values = policy_fn(states, legals)
            for i, node in enumerate(nodes):
                if self.max_leaves is not None and n_leaves >= self.max_leaves:
                    break
                a = int(actions[i])
                lchild, rchild = tree.split(
                    node, a, cut_matrix=self.cut_matrix
                )
                n_leaves += 1
                transitions.append(
                    Transition(
                        state=states[i],
                        legal=legals[i],
                        action=a,
                        logp=float(logps[i]),
                        value=float(values[i]),
                        node_key=id(node),
                    )
                )
                for child in (lchild, rchild):
                    lg = self.legal_actions(child)
                    if lg.any():
                        queue.append((child, lg))
        # episode done: compute rewards (Sec 5.2.2)
        rewards_by_node, scanned = rw.per_node_rewards(
            tree, self.sample, self.wt
        )
        for t in transitions:
            t.reward = rewards_by_node.get(t.node_key, 0.0)
        return EpisodeResult(
            tree=tree, transitions=transitions, scanned_fraction=scanned
        )
