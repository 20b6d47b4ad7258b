"""LM-training data pipeline on qd-tree blocks + elastic block scheduler.

This is where the paper's layout engine becomes a first-class feature of the
training framework: a *curation query* (mixture filter over record
metadata) selects training data; the qd-tree prunes the block set up front
(the store engine's ``route_query``: on the card one ``query_intersect``
launch), so workers never read non-matching blocks.  Blocks — having semantic
descriptions + completeness — are also the unit of data-parallel work
assignment, giving us:

  * straggler mitigation: a slow worker's unread blocks are re-queued and
    stolen by finished peers (handoff is metadata-only),
  * elastic scaling: the scheduler re-balances outstanding blocks when
    workers join/leave,
  * deterministic resume: (epoch, block-cursor) pairs are checkpointable.
"""

from __future__ import annotations

# qdlint: deterministic-module

import dataclasses
import threading
from collections import deque
from typing import Iterator, Optional

import numpy as np

from repro_torch.core import query as qry
from repro_torch.data.blocks import BlockStore


# ---------------------------------------------------------------------------
# Elastic block scheduler
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SchedulerState:
    epoch: int
    pending: list[int]  # block ids not yet handed out
    inflight: dict[int, list[int]]  # worker -> blocks handed out, unacked
    done: list[int]


class ElasticBlockScheduler:
    """Assigns qd-tree blocks to data-parallel workers with work stealing.

    The scheduler is deliberately tiny and deterministic: a shared pending
    deque (shuffled per epoch with a seeded RNG), per-worker in-flight sets,
    and three events — ``next_block`` (pull), ``ack`` (block consumed),
    ``fail`` (worker lost ⇒ its in-flight blocks are re-queued).  At fleet
    scale this runs on the coordinator; workers only pull BIDs.
    """

    def __init__(self, block_ids: list[int], seed: int = 0):
        self._all = list(block_ids)
        self._seed = seed
        self._lock = threading.Lock()
        self._epoch = -1  # guarded by: self._lock
        self._pending: deque[int] = deque()  # guarded by: self._lock
        self._inflight: dict[int, set[int]] = {}  # guarded by: self._lock
        self._done: set[int] = set()  # guarded by: self._lock
        self._start_epoch(0)

    def _start_epoch(self, epoch: int) -> None:  # qdlint: holds-lock
        rng = np.random.default_rng(self._seed + epoch)
        order = np.array(self._all)
        rng.shuffle(order)
        self._epoch = epoch
        self._pending = deque(int(b) for b in order)
        self._inflight = {}
        self._done = set()

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def next_block(self, worker: int) -> Optional[int]:
        """Pull the next block for ``worker``; None ⇒ epoch exhausted."""
        with self._lock:
            if not self._pending:
                return None
            b = self._pending.popleft()
            self._inflight.setdefault(worker, set()).add(b)
            return b

    def ack(self, worker: int, block: int) -> None:
        with self._lock:
            self._inflight.get(worker, set()).discard(block)
            self._done.add(block)
            if (
                not self._pending
                and not any(self._inflight.values())
                and len(self._done) == len(self._all)
            ):
                self._start_epoch(self._epoch + 1)

    def fail(self, worker: int) -> list[int]:
        """Worker lost: re-queue its unacked blocks (straggler mitigation)."""
        with self._lock:
            lost = sorted(self._inflight.pop(worker, set()))
            # stolen blocks go to the FRONT so they finish soonest
            self._pending.extendleft(reversed(lost))
            return lost

    def outstanding(self) -> int:
        with self._lock:
            return len(self._pending) + sum(
                len(v) for v in self._inflight.values()
            )

    # -- checkpointing --------------------------------------------------------
    def state(self) -> SchedulerState:
        with self._lock:
            return SchedulerState(
                epoch=self._epoch,
                pending=list(self._pending),
                inflight={k: sorted(v) for k, v in self._inflight.items()},
                done=sorted(self._done),
            )

    def restore(self, st: SchedulerState) -> None:
        with self._lock:
            self._epoch = st.epoch
            # in-flight blocks of a restored run are treated as pending again
            refill = [b for v in st.inflight.values() for b in v]
            self._pending = deque(refill + list(st.pending))
            self._inflight = {}
            self._done = set(st.done)


# ---------------------------------------------------------------------------
# Tokenization of records (synthetic — records become token sequences)
# ---------------------------------------------------------------------------
def records_to_tokens(
    rows: np.ndarray, seq_len: int, vocab: int, seed: int = 0
) -> np.ndarray:
    """Deterministic record → token-sequence expansion.

    Real deployments would read a text payload column; offline we derive a
    reproducible pseudo-corpus by seeding a Philox stream with each row's
    hash, so tests can assert exact batch equality across workers/restarts.
    """
    # row hash: cheap mixing of the int32 columns
    h = rows.astype(np.uint64)
    mix = np.uint64(0x9E3779B97F4A7C15)
    acc = np.zeros(rows.shape[0], np.uint64)
    for c in range(rows.shape[1]):
        acc = (acc ^ (h[:, c] + mix + (acc << np.uint64(6)))) * np.uint64(
            0x100000001B3
        )
    out = np.empty((rows.shape[0], seq_len), np.int32)
    for i in range(rows.shape[0]):
        rng = np.random.default_rng(np.uint64(seed) ^ acc[i])
        out[i] = rng.integers(0, vocab, seq_len, dtype=np.int32)
    return out


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PipelineConfig:
    batch_size: int  # sequences per batch, per worker
    seq_len: int
    vocab: int
    curation_query: Optional[qry.Query] = None  # None ⇒ all blocks
    seed: int = 0
    epochs: int = 1  # scheduler auto-advances; iterate this many epochs


class QdTreePipeline:
    """Per-worker iterator of (tokens, labels) batches with block skipping."""

    def __init__(
        self,
        store: BlockStore,
        cfg: PipelineConfig,
        scheduler: ElasticBlockScheduler | None = None,
        worker: int = 0,
    ):
        self.store = store
        self.cfg = cfg
        self.worker = worker
        if cfg.curation_query is not None:
            bids = store.engine.route_query(cfg.curation_query)
            self.block_ids = [int(b) for b in bids]
        else:
            self.block_ids = list(range(store.tree.n_leaves))
        self.blocks_skipped = store.tree.n_leaves - len(self.block_ids)
        self.scheduler = scheduler or ElasticBlockScheduler(
            self.block_ids, seed=cfg.seed
        )

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        buf: list[np.ndarray] = []
        buffered = 0
        target_epoch = self.scheduler.epoch + self.cfg.epochs
        while self.scheduler.epoch < target_epoch:
            b = self.scheduler.next_block(self.worker)
            if b is None:
                # epoch drained (possibly by peers); the scheduler advances
                # on the final ack — nothing left for this worker here.
                break
            rows = self.store.read_block(b)
            if self.cfg.curation_query is not None and rows.size:
                mask = self.cfg.curation_query.evaluate(
                    rows, self.store.tree.schema
                )
                rows = rows[mask]
            if rows.size:
                toks = records_to_tokens(
                    rows, self.cfg.seq_len + 1, self.cfg.vocab, self.cfg.seed
                )
                buf.append(toks)
                buffered += toks.shape[0]
            self.scheduler.ack(self.worker, b)
            while buffered >= self.cfg.batch_size:
                chunk = np.concatenate(buf)
                batch = chunk[: self.cfg.batch_size]
                rest = chunk[self.cfg.batch_size :]
                buf = [rest] if rest.size else []
                buffered = rest.shape[0] if rest.size else 0
                yield batch[:, :-1], batch[:, 1:]
