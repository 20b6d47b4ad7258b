"""Block store: persists a layout's blocks and serves scan queries.

This is the execution engine for the physical-runtime benchmarks (paper
Sec 7.4/7.5): each leaf block is stored columnar (npz), a manifest carries
sizes + semantic descriptions, and ``scan_query`` reads only the blocks the
qd-tree routes the query to (``BID IN (...)`` — paper Sec 3.3), counting
blocks/bytes/rows touched.

The files are the JAX package's (``block_XXXXXX.npz`` with one ``rows``
array, ``qdtree.npz`` with the tree's save keys, ``manifest.json``), so a
store written by either package opens in the other.  A batch on a CUDA
device, with its block ids there, is sorted by block on the device and
comes to the host in one copy; the buffered chunks are numpy either way.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time

import numpy as np
import torch

from repro_torch.core import query as qry
from repro_torch.core.qdtree import FrozenQdTree


class BlockBuffers:
    """In-memory per-block row buffers for streaming ingestion.

    ``LayoutEngine.ingest`` appends each routed micro-batch here; buffers
    accumulate per-BID row chunks (no per-batch rewrite of persisted
    blocks) and ``write_store`` materializes a :class:`BlockStore` once the
    stream drains.
    """

    def __init__(self, n_blocks: int, ndims: int, dtype=None):
        self.n_blocks = n_blocks
        self.ndims = ndims
        # None ⇒ adopt the first batch's dtype (no silent narrowing)
        self._dtype = None if dtype is None else np.dtype(dtype)
        self._chunks: list[list[np.ndarray]] = [[] for _ in range(n_blocks)]
        self.sizes = np.zeros(n_blocks, np.int64)

    @property
    def dtype(self) -> np.dtype:
        return self._dtype if self._dtype is not None else np.dtype(np.int32)

    @staticmethod
    def for_tree(tree: FrozenQdTree, dtype=None) -> "BlockBuffers":
        return BlockBuffers(tree.n_leaves, tree.schema.ndims, dtype)

    def append(self, records, bids) -> None:
        """Scatter one routed batch into the per-block buffers.

        Host numpy as the JAX package takes it, or a tensor batch with its
        block ids as a tensor on the same device: then the stable sort by
        block id, the counts and the gather run there
        (:func:`sort_by_block`), and the sorted rows and counts come back
        in one copy.  Any other mix is copied to the host first.
        """
        if records.shape[0] == 0:
            return
        if isinstance(records, torch.Tensor):
            if isinstance(bids, torch.Tensor):
                sorted_recs, counts = sort_by_block(records, bids,
                                                    self.n_blocks)
                self._scatter(sorted_recs, counts)
                return
            records = records.cpu().numpy()
        if isinstance(bids, torch.Tensor):
            bids = bids.cpu().numpy()
        if self._dtype is None:
            self._dtype = records.dtype
        order = np.argsort(bids, kind="stable")
        counts = np.bincount(bids, minlength=self.n_blocks)
        self._scatter(records[order], counts)

    def _scatter(self, sorted_recs: np.ndarray, counts: np.ndarray) -> None:
        """Chunks of rows already sorted by block id, ``counts`` a block."""
        if self._dtype is None:
            self._dtype = sorted_recs.dtype
        sorted_recs = sorted_recs.astype(self.dtype, copy=False)
        bounds = np.concatenate([[0], np.cumsum(counts)])
        for b in np.nonzero(counts)[0]:
            self._chunks[b].append(sorted_recs[bounds[b] : bounds[b + 1]])
        self.sizes += counts

    def append_block(self, bid: int, rows: np.ndarray) -> None:
        """Append pre-routed rows to one block (sharded-merge spill path).

        ``MergeCoordinator.publish`` folds each shard's per-block chunks in
        here in shard-id order, so a contiguous record split reproduces the
        single-stream buffer contents row-for-row.
        """
        if rows.shape[0] == 0:
            return
        if self._dtype is None:
            self._dtype = rows.dtype
        self._chunks[bid].append(rows.astype(self.dtype, copy=False))
        self.sizes[bid] += rows.shape[0]

    @property
    def n_rows(self) -> int:
        return int(self.sizes.sum())

    def block(self, bid: int) -> np.ndarray:
        chunks = self._chunks[bid]
        if not chunks:
            return np.zeros((0, self.ndims), self.dtype)
        return chunks[0] if len(chunks) == 1 else np.concatenate(chunks)

    def write_store(
        self, path: str | pathlib.Path, tree: FrozenQdTree
    ) -> "BlockStore":
        """Persist the buffered blocks as a BlockStore (npz + manifest)."""
        root = pathlib.Path(path)
        root.mkdir(parents=True, exist_ok=True)
        row_bytes = self.ndims * self.dtype.itemsize
        for b in range(self.n_blocks):
            np.savez(root / f"block_{b:06d}.npz", rows=self.block(b))
        tree.save(str(root / "qdtree.npz"))
        manifest = {
            "n_blocks": int(self.n_blocks),
            "sizes": self.sizes.tolist(),
            "row_bytes": row_bytes,
            "n_rows": self.n_rows,
        }
        (root / "manifest.json").write_text(json.dumps(manifest))
        return BlockStore(
            root=root,
            tree=tree,
            sizes=self.sizes.copy(),
            row_bytes=row_bytes,
        )


def sort_by_block(records: torch.Tensor, bids: torch.Tensor,
                  n_blocks: int) -> tuple[np.ndarray, np.ndarray]:
    """A batch's rows stably sorted by block id, and its rows a block.

    The sort, the counts and the gather run on the tensors' device; the
    sorted rows and the counts come back to the host in one copy, as one
    int32 buffer.  Stable, so each block keeps the batch's row order: the
    rows are those of a host ``argsort(kind="stable")``, row for row.
    """
    if records.device != bids.device:
        raise ValueError(f"records on {records.device}, block ids on "
                         f"{bids.device}")
    if records.dtype != torch.int32:
        raise ValueError(f"records must be int32, not {records.dtype}")
    m, d = records.shape
    order = torch.sort(bids, stable=True).indices
    out = torch.empty(m * d + n_blocks, dtype=torch.int32,
                      device=records.device)
    torch.index_select(records, 0, order, out=out[: m * d].view(m, d))
    out[m * d :] = torch.bincount(bids, minlength=n_blocks)
    host = out.cpu().numpy()
    return host[: m * d].reshape(m, d), host[m * d :].astype(np.int64)


@dataclasses.dataclass
class ScanResult:
    rows: np.ndarray  # exact matching records
    blocks_considered: int
    blocks_read: int
    bytes_read: int
    rows_scanned: int
    wall_s: float


@dataclasses.dataclass
class BlockStore:
    root: pathlib.Path
    tree: FrozenQdTree
    sizes: np.ndarray  # rows per block
    row_bytes: int
    # where the store's engine routes queries (None: the GPU); used when
    # the store's tree has no engine attached yet
    device: object = None

    # -- construction --------------------------------------------------------
    @staticmethod
    def create(
        path: str | pathlib.Path,
        tree: FrozenQdTree,
        records,
        backend: str = "torch",
        device=None,
    ) -> "BlockStore":
        """Route all records and persist one npz per block.

        One-shot convenience over the streaming path: a single ``ingest``
        batch through the tree's LayoutEngine.
        """
        dtype = (np.int32 if isinstance(records, torch.Tensor)
                 else records.dtype)
        return BlockStore.create_streaming(
            path, tree, [records], backend=backend, dtype=dtype,
            device=device,
        )

    @staticmethod
    def create_streaming(
        path: str | pathlib.Path,
        tree: FrozenQdTree,
        batches,
        backend: str = "torch",
        dtype=None,
        device=None,
    ) -> "BlockStore":
        """Ingest a stream of record micro-batches into a new store.

        Routes each batch through the LayoutEngine (on the GPU unless the
        tree's engine or ``device`` says otherwise), buffers rows per
        block, incrementally tightens leaf descriptions, then persists.
        """
        from repro_torch.engine import engine_for

        buffers = BlockBuffers(tree.n_leaves, tree.schema.ndims, dtype)
        engine_for(tree, device=device).ingest(
            batches, tighten=True, buffers=buffers, backend=backend
        )
        store = buffers.write_store(path, tree)
        store.device = device
        return store

    @staticmethod
    def open(path: str | pathlib.Path, device=None) -> "BlockStore":
        root = pathlib.Path(path)
        manifest = json.loads((root / "manifest.json").read_text())
        tree = FrozenQdTree.load(str(root / "qdtree.npz"))
        return BlockStore(
            root=root,
            tree=tree,
            sizes=np.asarray(manifest["sizes"], np.int64),
            row_bytes=int(manifest["row_bytes"]),
            device=device,
        )

    # -- engine access -------------------------------------------------------
    @property
    def engine(self):
        """The store's LayoutEngine (shared plan cache via the tree)."""
        from repro_torch.engine import engine_for

        return engine_for(self.tree, device=self.device)

    # -- reads ---------------------------------------------------------------
    def read_block(self, bid: int) -> np.ndarray:
        with np.load(self.root / f"block_{bid:06d}.npz") as z:
            return z["rows"]

    def scan_query(
        self, query: qry.Query, use_routing: bool = True
    ) -> ScanResult:
        """Execute a query: route → read → exact filter.

        The route is the engine's ``route_query`` (on the GPU, one
        ``query_intersect`` launch); reading and filtering stay on the host.
        ``use_routing=False`` is the paper's *no route* ablation: every
        block whose min-max description intersects is still skipped (the
        tightened descriptions double as min-max indexes), but without the
        qd-tree BID list the store must consider all blocks' metadata.
        Both paths read the same blocks here because our descriptions
        subsume min-max — the physical difference (explicit BID pushdown)
        shows up in metadata touch counts.
        """
        t0 = time.perf_counter()
        bids = self.engine.route_query(query)
        rows_out = []
        bytes_read = 0
        rows_scanned = 0
        for b in bids:
            rows = self.read_block(int(b))
            if rows.size == 0:
                continue
            rows_scanned += rows.shape[0]
            bytes_read += rows.shape[0] * self.row_bytes
            mask = query.evaluate(rows, self.tree.schema)
            if mask.any():
                rows_out.append(rows[mask])
        out = (
            np.concatenate(rows_out)
            if rows_out
            else np.zeros((0, self.tree.schema.ndims), np.int32)
        )
        return ScanResult(
            rows=out,
            blocks_considered=(
                len(bids) if use_routing else self.tree.n_leaves
            ),
            blocks_read=len(bids),
            bytes_read=bytes_read,
            rows_scanned=rows_scanned,
            wall_s=time.perf_counter() - t0,
        )
