"""Sharded ingestion: parallel shard routing with associative merge.

The qd-tree gives a complete semantic description of every block (paper
Sec 3.2), which makes ingestion shardable: any worker holding a replica of
the routing plan can assign records to blocks independently, and the
per-block aggregates — row counts, min/max tightener partials, categorical
presence masks, advanced-cut truth bits — all merge associatively (sum /
min / max / or over int64 and bool are exact, so the fold is bit-identical
regardless of association or order).  Three pieces:

* :class:`ShardIngestor` routes one shard's micro-batches and accumulates
  a serializable :class:`ShardState`: per-block row counts, per-leaf
  min/max tightener partials, and (optionally) per-block row chunks — the
  spill manifest a remote shard would ship back alongside its state.  On
  the torch backend a shard folds every batch into ONE device accumulator
  (``fused_ingest`` per batch) and copies it back once, at the end of the
  shard; the numpy backend keeps the host tightener.
* :class:`MergeCoordinator` folds ShardStates associatively and publishes
  the merged tightening into the tree — bit-identical to single-stream
  ``LayoutEngine.ingest`` over the same records.
* :func:`sharded_ingest` wires both onto a ``concurrent.futures``
  executor.  ``executor="process"`` takes the multi-host shape:
  spawn-context workers in the resident module pool hold a
  :class:`ProcessShardSession` replica of the routing plan, on the parent
  engine's device, and ship only the (pure-numpy, pickle/npz-serializable)
  ShardState back.  ``executor="thread"`` shares the live engine's plans;
  on a GPU each thread shard runs under its own CUDA stream.

Which executor is the default depends on the engine's device
(:func:`resolve_executor`): on the CPU, shards contend on the GIL, so
``"process"`` for ``n_shards >= 2``, as in the JAX package; on one GPU, k
processes are k CUDA contexts time-slicing one card, while thread shards
share one context and its streams, so the default there is
:data:`CUDA_DEFAULT_EXECUTOR`, ``"thread"``, the one measured faster at
k = 4 (its comment gives both times).

The process path streams rounds through a :class:`ProcessShardSession`:
the tree replica is shipped AT MOST ONCE per pool worker per tree
generation (round tasks carry a session token; an unseeded worker raises
:class:`ReplicaMissing` and the parent retries that one task with the
payload attached), and the parent folds ShardStates as they complete —
merge overlaps the slower shards' routing.  Workers never fork: CUDA does
not survive a fork.
"""

from __future__ import annotations

# qdlint: deterministic-module

import atexit
import contextlib
import dataclasses
import itertools
import multiprocessing
import os
import tempfile
import threading
import time
import warnings
from concurrent.futures import (
    Executor,
    ProcessPoolExecutor,
    ThreadPoolExecutor,
    as_completed,
)
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch.core.qdtree import FrozenQdTree, IncrementalTightener
from repro_torch.engine import plan as planlib
from repro_torch.engine.backends import as_host
from repro_torch.engine.engine import (
    IngestReport,
    LayoutEngine,
    ObservationProbe,
    WindowStat,
    engine_for,
)
from repro_torch.kernels import _build


class PerformanceWarning(UserWarning):
    """A requested configuration is known to lose wall-clock."""


# The default executor for k >= 2 shards of an engine on a GPU: the one
# chip_smoke.py measured faster at k = 4 over its 40M-row table, batches of
# 2**20 (PERF.md §6): thread shards 22.152 ms, process shards
# 465.870 ms (medians of 5, NVIDIA H100 80GB HBM3 at 700.00 W).  Threads
# share one CUDA context; four processes time-slice the card between four.
CUDA_DEFAULT_EXECUTOR = "thread"

_THREAD_FOOTGUN = (
    "executor='thread' with n_shards={k} on the CPU: shard routing shares "
    "one GIL; executor='process' (the default for n_shards >= 2 on the "
    "CPU) routes shards in resident spawn workers instead"
)
_CUDA_FOOTGUN = (
    "executor={executor!r} with n_shards={k} on a GPU: k spawn workers are "
    "k CUDA contexts time-slicing one card; executor="
    f"{CUDA_DEFAULT_EXECUTOR!r} (the default on a GPU) runs the shards on "
    "CUDA streams of one context instead"
)


def resolve_executor(
    executor: "Executor | str | None",
    n_shards: int,
    stacklevel: int = 3,
    device=None,
) -> "Executor | str":
    """Resolve the sharded-ingest executor default.

    ``None`` picks ``"thread"`` for a single shard (no parallelism to
    lose, no pool to keep resident).  For ``n_shards >= 2`` it picks
    ``"process"`` on the CPU — the only executor that escapes the GIL —
    and :data:`CUDA_DEFAULT_EXECUTOR` for an engine on a CUDA ``device``.
    An explicit choice of the other executor with several shards emits
    :class:`PerformanceWarning` but is honored: shared-plan thread shards
    remain the right tool for deterministic tests and for custom
    ``Executor`` protocols.
    """
    on_gpu = device is not None and torch.device(device).type == "cuda"
    default = CUDA_DEFAULT_EXECUTOR if on_gpu else "process"
    if executor is None:
        return default if n_shards >= 2 else "thread"
    if isinstance(executor, str):
        if executor not in ("thread", "process"):
            raise ValueError(
                f"executor must be 'thread', 'process', an Executor, or "
                f"None — got {executor!r}"
            )
        if executor != default and n_shards > 1:
            text = (_CUDA_FOOTGUN.format(executor=executor, k=n_shards)
                    if on_gpu else _THREAD_FOOTGUN.format(k=n_shards))
            warnings.warn(text, PerformanceWarning, stacklevel=stacklevel)
    return executor


@dataclasses.dataclass
class ShardState:
    """One shard's (or a merged set of shards') ingestion aggregates.

    Pure numpy + builtins: picklable for process pools and npz-serializable
    for cross-host shipping, with the JAX package's npz keys, so a state
    saved by either package loads in the other.  ``lo``/``hi`` use the
    IncrementalTightener's int64 identity elements (+inf/-inf analogues),
    so states merge before any narrowing to the tree's dtypes.

    ``chunks`` maps BID → list of ``(shard_id, rows)`` buffered row chunks
    (empty when the ingestor ran with ``collect_blocks=False``).  Chunk
    lists concatenate under merge and are sorted by shard id at publish
    time, so block contents are independent of merge order too.

    ``obs`` carries the shard's Eq. 1 skip-rate accounting partial (a
    :class:`~repro_torch.engine.engine.WindowStat`, all-zero when the
    ingestor ran without an observation probe).  Its merge is an exact int
    sum, so the folded window stats are bit-identical to the single-stream
    per-batch sequence for every shard count.
    """

    shard_ids: tuple[int, ...]
    n_leaves: int
    counts: np.ndarray  # (L,) int64 rows routed per block
    lo: np.ndarray  # (L, D) int64 running minima
    hi: np.ndarray  # (L, D) int64 running maxima (exclusive)
    cat: np.ndarray  # (L, bits) bool observed categorical values
    adv: np.ndarray  # (L, A, 2) bool observed advanced-cut truth bits
    n_batches: int
    n_records: int
    chunks: dict[int, list[tuple[int, np.ndarray]]]
    wall_s: float = 0.0
    obs: WindowStat = dataclasses.field(default_factory=WindowStat)

    def merge(self, other: "ShardState") -> "ShardState":
        """Associative, commutative fold of two shard states.

        Every aggregate is an exact elementwise monoid op on int64/bool,
        so ``merge(merge(a, b), c)`` equals ``merge(a, merge(b, c))``
        bit-identically, and the tightening aggregates commute as well.
        """
        if self.n_leaves != other.n_leaves or self.lo.shape != other.lo.shape:
            raise ValueError("cannot merge shard states of different trees")
        overlap = set(self.shard_ids) & set(other.shard_ids)
        if overlap:
            raise ValueError(f"shards merged twice: {sorted(overlap)}")
        chunks: dict[int, list[tuple[int, np.ndarray]]] = {
            b: list(c) for b, c in self.chunks.items()
        }
        for b, c in other.chunks.items():
            chunks.setdefault(b, []).extend(c)
        return ShardState(
            shard_ids=tuple(sorted(self.shard_ids + other.shard_ids)),
            n_leaves=self.n_leaves,
            counts=self.counts + other.counts,
            lo=np.minimum(self.lo, other.lo),
            hi=np.maximum(self.hi, other.hi),
            cat=self.cat | other.cat,
            adv=self.adv | other.adv,
            n_batches=self.n_batches + other.n_batches,
            n_records=self.n_records + other.n_records,
            chunks=chunks,
            wall_s=max(self.wall_s, other.wall_s),
            obs=self.obs.merge(other.obs),
        )

    # -- serialization (cross-host shipping) --------------------------------
    def save(self, path: str) -> None:
        arrays = {
            "shard_ids": np.asarray(self.shard_ids, np.int64),
            "counts": self.counts,
            "lo": self.lo,
            "hi": self.hi,
            "cat": self.cat,
            "adv": self.adv,
            "meta": np.asarray(
                [self.n_leaves, self.n_batches, self.n_records], np.int64
            ),
            "wall_s": np.asarray(self.wall_s),
            "obs": self.obs.to_array(),
        }
        for b, clist in self.chunks.items():
            for sid, rows in clist:
                arrays[f"chunk_{int(sid)}_{int(b)}"] = rows
        np.savez_compressed(path, **arrays)

    @staticmethod
    def load(path: str) -> "ShardState":
        z = np.load(path, allow_pickle=False)
        chunks: dict[int, list[tuple[int, np.ndarray]]] = {}
        for key in z.files:
            if key.startswith("chunk_"):
                _, sid, b = key.split("_")
                chunks.setdefault(int(b), []).append((int(sid), z[key]))
        for clist in chunks.values():
            clist.sort(key=lambda c: c[0])
        meta = z["meta"]
        return ShardState(
            shard_ids=tuple(int(s) for s in z["shard_ids"]),
            n_leaves=int(meta[0]),
            counts=z["counts"],
            lo=z["lo"],
            hi=z["hi"],
            cat=z["cat"],
            adv=z["adv"],
            n_batches=int(meta[1]),
            n_records=int(meta[2]),
            chunks=chunks,
            wall_s=float(z["wall_s"]),
            obs=(
                WindowStat.from_array(z["obs"])
                if "obs" in z.files
                else WindowStat()
            ),
        )


class ShardIngestor:
    """Routes one shard's micro-batches against a replicated plan.

    Holds no shared mutable state: routing reads the (immutable) frozen
    topology through the engine's plan cache, and all accumulation happens
    in a private accumulator that is *never applied* to the tree — its
    partial is extracted into the returned ShardState.

    On a GPU the shard runs under a CUDA stream of its own, which first
    waits for ``source_stream`` (the stream that wrote the records; the
    current stream of the calling thread by default); its accumulator and
    block ids are allocated under it.
    """

    def __init__(
        self,
        layout: FrozenQdTree | LayoutEngine,
        shard_id: int = 0,
        backend: Optional[str] = None,
        collect_blocks: bool = False,
        probe: Optional[ObservationProbe] = None,
        fused: bool = True,
        source_stream=None,  # torch.cuda.Stream | None
    ):
        self.engine = (
            layout
            if isinstance(layout, LayoutEngine)
            else engine_for(layout)
        )
        self.shard_id = int(shard_id)
        self.backend = backend
        self.collect_blocks = collect_blocks
        # replicated per-leaf hit counts (engine.observation_probe): every
        # shard scores against the SAME probe arrays, so the summed
        # window-stat partials are bit-identical to single-stream ingest
        self.probe = probe
        self.fused = fused
        self.source_stream = source_stream

    def _stream(self):
        """The shard's own CUDA stream, after the records' writer."""
        dev = self.engine.device
        if dev.type != "cuda":
            return None
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(self.source_stream
                           if self.source_stream is not None
                           else torch.cuda.current_stream(dev))
        return stream

    def run(self, batches: Iterable) -> ShardState:
        """Route every micro-batch; return this shard's aggregates."""
        t0 = time.perf_counter()
        stream = self._stream()
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            return self._run(batches, t0)

    def _run(self, batches: Iterable, t0: float) -> ShardState:
        from repro_torch.data.blocks import BlockBuffers

        engine = self.engine
        tree = engine.tree
        tightener = IncrementalTightener(tree)
        # one running accumulator a shard (on the torch backend it stays on
        # the device), copied back once after the last batch
        acc = (
            engine._backend(self.backend).accumulator(
                tree, engine.plans, engine.device)
            if self.fused else None
        )
        # private per-shard buffers reuse the exact routing-order-preserving
        # scatter of the single-stream path (BlockBuffers.append)
        spill = (
            BlockBuffers.for_tree(tree) if self.collect_blocks else None
        )
        n_batches = n_records = 0
        obs = WindowStat()
        # a partials-only shard (no spill, no probe) streams aggregates,
        # never rows — skip the per-row block-id device→host transfer
        need_bids = spill is not None or self.probe is not None
        for batch in batches:
            if batch.shape[0] == 0:
                continue
            if self.fused:
                bids = acc.fold(
                    batch, return_bids=need_bids,
                    on_device=(spill is not None
                               and not isinstance(batch, np.ndarray)),
                )
            else:
                bids = engine.route(batch, backend=self.backend)
                tightener.update(as_host(batch), bids)
            if spill is not None:
                spill.append(batch, bids)
            if self.probe is not None:
                obs = obs.merge(self.probe.observe(as_host(bids)))
            n_batches += 1
            n_records += batch.shape[0]
        if self.fused:
            tightener.merge(acc.partial())
        chunks = (
            {}
            if spill is None
            else {
                int(b): [(self.shard_id, spill.block(int(b)))]
                for b in np.nonzero(spill.sizes)[0]
            }
        )
        return ShardState(
            shard_ids=(self.shard_id,),
            n_leaves=tree.n_leaves,
            counts=tightener.counts,
            lo=tightener.lo,
            hi=tightener.hi,
            cat=tightener.cat,
            adv=tightener.adv,
            n_batches=n_batches,
            n_records=n_records,
            chunks=chunks,
            wall_s=time.perf_counter() - t0,
            obs=obs,
        )


class MergeCoordinator:
    """Folds ShardStates and publishes the merged tightening into a tree."""

    def __init__(self, tree: FrozenQdTree):
        self.tree = tree
        self._state: Optional[ShardState] = None

    @property
    def merged(self) -> ShardState:
        if self._state is None:
            raise ValueError("no shard states merged yet")
        return self._state

    def add(self, state: ShardState) -> ShardState:
        self._state = state if self._state is None else self._state.merge(state)
        return self._state

    def publish(self, buffers=None) -> np.ndarray:
        """Apply the merged tightening to the tree; returns block sizes.

        Reuses ``IncrementalTightener.apply`` verbatim, so the published
        leaf descriptions — and the description-version bump that evicts
        stale query plans — are exactly what single-stream ``ingest``
        would have produced.  ``buffers`` is forwarded to
        :meth:`fill_buffers`.
        """
        state = self.merged
        t = IncrementalTightener(self.tree)
        t.lo, t.hi = state.lo, state.hi
        t.cat, t.adv = state.cat, state.adv
        t.counts = state.counts
        t.apply()
        if buffers is not None:
            self.fill_buffers(buffers)
        return state.counts.copy()

    def fill_buffers(self, buffers) -> None:
        """Drain the merged spill chunks into ``buffers`` (a BlockBuffers).

        Chunks are folded in shard-id order, so with a contiguous record
        split the buffered blocks match single-stream ingestion
        row-for-row.  Does not touch the tree — usable for what-if runs
        alongside ``tighten=False``.
        """
        state = self.merged
        for b in sorted(state.chunks):
            for _, rows in sorted(state.chunks[b], key=lambda c: c[0]):
                buffers.append_block(b, rows)


@dataclasses.dataclass
class ShardedIngestReport(IngestReport):
    """IngestReport plus shard-parallel accounting.

    (Defaults exist only because the base class carries defaulted fields;
    :func:`sharded_ingest` always sets these.)

    ``published`` is True iff the merged tightening was applied to the
    tree; ``stale_generation`` is True when a requested publish was
    *skipped* because the caller's ``publish_check`` reported that the
    tree is no longer the live generation (hot-swapped out mid-run) — the
    aggregates in this report are still valid for the captured tree, but
    nothing was mutated.
    """

    n_shards: int = 0
    shard_wall_s: tuple[float, ...] = ()  # per-shard routing wall clock
    merge_s: float = 0.0  # publish step (the fold itself streams,
    # overlapped with routing, so it no longer shows up here)
    published: bool = False
    stale_generation: bool = False
    state: "Optional[ShardState]" = None  # merged partial (keep_state=True)

    @property
    def shard_records_per_s(self) -> float:
        """Aggregate routing throughput of the shard pool (merge excluded)."""
        slowest = max(self.shard_wall_s) if self.shard_wall_s else 0.0
        return self.n_records / slowest if slowest else 0.0


def shard_slices(records, n_shards: int) -> list:
    """Contiguous record split — shard i gets the i-th slice of the stream.

    Views of a numpy array or of a tensor (on any device), split as
    ``np.array_split`` splits: the first ``len % n_shards`` slices take one
    row more.
    """
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    if isinstance(records, torch.Tensor):
        return list(torch.tensor_split(records, n_shards))
    return np.array_split(records, n_shards)


def micro_batches(records, batch: int):
    for s in range(0, records.shape[0], batch):
        yield records[s : s + batch]


def warm_sizes(n_rows: int, n_shards: int, batch: int) -> set[int]:
    """Every distinct batch size a sharded run will route.

    Derived from :func:`shard_slices` (floor/ceil contiguous split) +
    :func:`micro_batches` (fixed ``batch`` plus a tail remainder), so
    callers can pre-warm exactly the plans the run will use.
    """
    slice_sizes = {n_rows // n_shards}
    if n_rows % n_shards:
        slice_sizes.add(n_rows // n_shards + 1)
    sizes = {min(batch, s) for s in slice_sizes}
    sizes |= {s % batch for s in slice_sizes}
    return {s for s in sizes if s}


def _run_shard(ingestor: ShardIngestor, batches) -> ShardState:
    """Module-level executor target (keeps futures introspectable)."""
    return ingestor.run(batches)


# -- resident spawn pool -----------------------------------------------------
# Workers are stateless (each task ships a session token, or its own tree
# replica, and returns a pure-numpy ShardState), so one module-level pool
# can serve every run; it is built lazily at the first ``process_pool``
# call, grows (never shrinks) to the largest shard count requested, and
# lives until ``shutdown_process_pool`` or interpreter exit.  Its workers
# are spawned, never forked: CUDA does not survive a fork.
_pool_lock = threading.Lock()
_pool: Optional[ProcessPoolExecutor] = None  # guarded by: _pool_lock
_pool_workers = 0  # guarded by: _pool_lock


def process_pool(min_workers: int = 1) -> ProcessPoolExecutor:
    """The resident spawn pool backing ``executor="process"`` runs.

    Returns a ProcessPoolExecutor with at least ``min_workers`` workers,
    creating or growing it as needed (growth replaces the pool — spawn
    pools cannot resize — after draining the old one).  A pool whose
    workers died (BrokenProcessPool) is rebuilt.
    """
    global _pool, _pool_workers
    if min_workers < 1:
        raise ValueError("min_workers must be >= 1")
    with _pool_lock:
        broken = _pool is not None and getattr(_pool, "_broken", False)
        if _pool is None or broken or _pool_workers < min_workers:
            old = _pool
            workers = max(min_workers, _pool_workers)
            _pool = ProcessPoolExecutor(
                max_workers=workers,
                mp_context=multiprocessing.get_context("spawn"),
            )
            _pool_workers = workers
            if old is not None:
                old.shutdown(wait=not broken)
        return _pool


def shutdown_process_pool(wait: bool = True) -> None:
    """Tear down the resident spawn pool (next use rebuilds it lazily)."""
    global _pool, _pool_workers
    with _pool_lock:
        pool, _pool, _pool_workers = _pool, None, 0
    if pool is not None:
        pool.shutdown(wait=wait)


atexit.register(shutdown_process_pool, wait=False)


# -- resident worker replicas (the session protocol) -------------------------
# Worker-process-side session cache.  Each spawn worker is single-threaded
# (ProcessPoolExecutor runs one task at a time per worker) and the parent
# never touches this dict, so no lock guards it.  Keyed by session token;
# bounded by insertion-order eviction so abandoned sessions cannot pin
# engines forever.
_WORKER_KEEP = 4
_WORKER_STATE: dict[str, dict] = {}

#: parent-side token counter — tokens are identity, never folded into data
_session_ids = itertools.count(1)


class ReplicaMissing(RuntimeError):
    """A pool worker was handed a round for a session it has not been
    seeded with.  The parent catches this and retries that ONE task with
    the ``(tree, records_path)`` payload attached — the
    ship-until-confirmed protocol that bounds replica pickling to at
    most once per worker per session."""


def _worker_engine(tree: FrozenQdTree, device: str) -> LayoutEngine:
    """A worker's engine, on the parent engine's device — never another.

    A CUDA parent gives CUDA workers; a worker that has no CUDA device
    raises rather than run on the CPU.
    """
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the parent engine is on {device}, and this worker process "
            f"(pid {os.getpid()}) has no CUDA device"
        )
    return engine_for(tree, device=device)


def _worker_entry(token: str, tree, records_path: Optional[str],
                  device: str) -> dict:
    """Fetch-or-install this worker's session entry (idempotent)."""
    entry = _WORKER_STATE.get(token)
    if entry is None:
        entry = {
            "engine": _worker_engine(tree, device),
            "records": None,
            "resident": {},  # (n_shards, shard_id) -> staged rows, a tensor
            "warmed": set(),
        }
        _WORKER_STATE[token] = entry
        while len(_WORKER_STATE) > _WORKER_KEEP:
            evict = next(iter(_WORKER_STATE))
            if evict == token:
                break
            del _WORKER_STATE[evict]
    if records_path is not None and entry["records"] is None:
        # memory-map: k workers on one host share the page cache instead
        # of holding k private copies of the staged stream
        entry["records"] = np.load(records_path, mmap_mode="r")
    return entry


def _worker_seed(
    token: str, tree, records_path: Optional[str], device: str,
    linger_s: float = 0.0,
) -> int:
    """Idempotently install the session replica in this pool worker.

    ``linger_s``: an already-seeded worker naps briefly before returning,
    so a wave of seed tasks drains toward the workers that still need
    one (a ProcessPoolExecutor cannot target a specific worker).
    Returns this worker's pid, the parent's coverage receipt.
    """
    if token in _WORKER_STATE and linger_s > 0.0:
        time.sleep(linger_s)
    _worker_entry(token, tree, records_path, device)
    return os.getpid()


def _worker_device(token: str, tree, records_path: Optional[str],
                   device: str) -> tuple[int, str]:
    """This worker's pid and its session engine's device, the session
    installed first if this worker has not seen it."""
    entry = _worker_entry(token, tree, records_path, device)
    return os.getpid(), str(entry["engine"].device)


def _staged_rows(entry: dict, n_shards: int, shard_id: int):
    """Shard ``shard_id``'s slice of the staged stream, as a tensor on the
    worker engine's device: copied out of the memory map (and to the
    card) once a session, and kept."""
    key = (n_shards, shard_id)
    if key not in entry["resident"]:
        rows = shard_slices(entry["records"], n_shards)[shard_id]
        host = np.array(rows, dtype=np.int32)  # private and writable
        entry["resident"][key] = torch.from_numpy(host).to(
            entry["engine"].device)
    return entry["resident"][key]


def _worker_round(
    token: str,
    shard_id: int,
    n_shards: int,
    rows: Optional[np.ndarray],
    batch: int,
    backend: Optional[str],
    collect_blocks: bool,
    probe: Optional[ObservationProbe],
    fused: bool,
    device: str,
    seed=None,  # (tree, records_path) | None — ReplicaMissing retry payload
) -> tuple[int, ShardState, dict]:
    """Run one shard round against this worker's resident session engine.

    ``rows`` is the shard's record slice (shipped mode) or None (staged
    mode: the worker slices its resident record array locally, so the
    task carries no rows at all).  Plans warm once per distinct batch
    size, per worker per session.  Returns the worker's pid, the shard's
    state and the kernel launches its run made (warm-ups excluded).
    """
    if token not in _WORKER_STATE and seed is None:
        raise ReplicaMissing(token)
    entry = _worker_entry(
        token, *(seed if seed is not None else (None, None)), device
    )
    engine = entry["engine"]
    if rows is None:
        if entry["records"] is None:
            raise ReplicaMissing(token)  # staged round, nothing staged here
        rows = _staged_rows(entry, n_shards, shard_id)
    need = warm_sizes(rows.shape[0], 1, batch) - entry["warmed"]
    if need:
        if fused:
            engine.warm_ingest(need, backend=backend)
        else:
            d = engine.tree.leaf_lo.shape[1]
            for s in sorted(need):
                engine.route(np.zeros((s, d), np.int32), backend=backend)
        entry["warmed"] |= need
    ingestor = ShardIngestor(
        engine, shard_id=shard_id, backend=backend,
        collect_blocks=collect_blocks, probe=probe, fused=fused,
    )
    before = _build.launch_counts()
    state = ingestor.run(micro_batches(rows, batch))
    after = _build.launch_counts()
    return os.getpid(), state, {k: after[k] - before[k] for k in after}


def _unlink_quiet(path: str) -> None:
    with contextlib.suppress(OSError):
        os.unlink(path)


class ProcessShardSession:
    """Parent-side handle streaming sharded rounds to the resident pool.

    A session ships the replica AT MOST ONCE per pool worker per tree
    generation: round tasks carry only a token; a worker that has not been
    seeded raises :class:`ReplicaMissing` and the parent retries that one
    task with the payload attached.  Ingest/routing plan keys do not
    include leaf descriptions, so a worker's warm plans stay valid across
    the parent's tightening publishes — a session lives until the tree
    object itself is replaced (rebuild / hot swap).

    The session carries the parent engine's device: every worker's engine
    is made there (a CPU parent gives CPU workers, a CUDA parent CUDA
    workers, or the worker raises).  :meth:`stage` spills the stream to a
    temp ``.npy`` once (a table on the GPU is copied to the host once for
    it) and has workers memory-map it; a GPU worker copies its slice to
    the device at its first round and keeps it there.

    Thread-safe: concurrent :meth:`round` calls are independent; the
    shared counters below are folded under the session lock.
    """

    def __init__(
        self,
        layout: FrozenQdTree | LayoutEngine,
        n_shards: int,
        batch: int = 2048,
        backend: Optional[str] = None,
        fused: bool = True,
    ):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.engine = (
            layout
            if isinstance(layout, LayoutEngine)
            else engine_for(layout)
        )
        self.n_shards = int(n_shards)
        self.batch = int(batch)
        self.backend = backend
        self.fused = bool(fused)
        self.device = str(self.engine.device)
        self.replica = replicate_tree(self.engine.tree)
        self.token = f"shardsess-{os.getpid()}-{next(_session_ids)}"
        self._lock = threading.Lock()
        self._records_path: Optional[str] = None  # guarded by: self._lock
        self._seeded: set[int] = set()  # guarded by: self._lock -- confirmed worker pids
        self._reseeds = 0  # guarded by: self._lock -- ReplicaMissing retries served
        self._rounds = 0  # guarded by: self._lock
        self._launches: dict[str, int] = {}  # guarded by: self._lock -- last round's
        self._closed = False  # guarded by: self._lock

    @property
    def pool(self) -> ProcessPoolExecutor:
        """The resident module pool, grown to this session's shard count."""
        return process_pool(self.n_shards)

    def stats(self) -> dict:
        with self._lock:
            return {
                "token": self.token,
                "rounds": self._rounds,
                "reseeds": self._reseeds,
                "seeded_workers": len(self._seeded),
                "staged": self._records_path is not None,
                # kernel launches the workers made in the last round
                "launches": dict(self._launches),
            }

    def worker_devices(self) -> dict[int, str]:
        """The device each probed worker's session engine is on, by pid:
        one probe task a shard, which installs the session in a worker
        that lacks it (so a worker that cannot reach the session's device
        raises here)."""
        with self._lock:
            path = self._records_path
        futs = [self.pool.submit(_worker_device, self.token, self.replica,
                                 path, self.device)
                for _ in range(self.n_shards)]
        return dict(f.result() for f in futs)

    def stage(self, records, max_waves: int = 16) -> int:
        """Make ``records`` resident in the pool workers.

        Spills the array (a tensor is copied to the host once) to a temp
        ``.npy`` (workers memory-map it — one page-cache copy per host,
        not one per worker), then pre-seeds the pool.  Subsequent
        ``round(None)`` calls slice the staged stream worker-side.
        Returns confirmed worker count.
        """
        fd, path = tempfile.mkstemp(prefix="qdshard-", suffix=".npy")
        os.close(fd)
        np.save(path, np.ascontiguousarray(as_host(records)))
        with self._lock:
            if self._closed:
                _unlink_quiet(path)
                raise RuntimeError("session is closed")
            old, self._records_path = self._records_path, path
        if old is not None:
            _unlink_quiet(old)
        return self.seed(max_waves=max_waves)

    def seed(self, max_waves: int = 16, linger_s: float = 0.02) -> int:
        """Best-effort pre-seed of every pool worker.

        Waves of idempotent seed tasks; already-seeded workers linger
        briefly so the queue drains toward unseeded ones.  Correctness
        never depends on coverage — an unseeded worker is caught by the
        ReplicaMissing retry in :meth:`round` — this just keeps
        first-round timings honest.  Returns confirmed worker count.
        """
        pool = self.pool
        with self._lock:
            path = self._records_path
        procs = getattr(pool, "_processes", None)
        target = len(procs) if procs else self.n_shards
        for _ in range(max_waves):
            with self._lock:
                if len(self._seeded) >= target:
                    break
            futs = [
                pool.submit(
                    _worker_seed, self.token, self.replica, path,
                    self.device, linger_s,
                )
                for _ in range(self.n_shards)
            ]
            pids = [f.result() for f in futs]
            with self._lock:
                self._seeded.update(pids)
        with self._lock:
            return len(self._seeded)

    def round(
        self,
        records=None,
        collect_blocks: bool = False,
        probe: Optional[ObservationProbe] = None,
        fold=None,  # Callable[[ShardState], None] | None
    ) -> list[ShardState]:
        """Run one k-shard routing round; returns states in shard order.

        ``records=None`` uses the staged stream (each worker slices its
        resident copy locally); otherwise the given array (a tensor is
        copied to the host) is split and its slices shipped with the
        tasks.  ``fold`` (if given) is called with each ShardState as it
        completes, so the parent's associative merge overlaps the slower
        shards' routing (the merge commutes bit-exactly, so completion
        order cannot change the result).  A failing worker's exception
        propagates.
        """
        with self._lock:
            if self._closed:
                raise RuntimeError("session is closed")
            path = self._records_path
        if records is None and path is None:
            raise ValueError(
                "no records given and none staged; call stage() first"
            )
        parts = (
            shard_slices(as_host(records), self.n_shards)
            if records is not None
            else None
        )
        pool = self.pool

        def _submit(i: int, seed):
            rows = parts[i] if parts is not None else None
            return pool.submit(
                _worker_round, self.token, i, self.n_shards, rows,
                self.batch, self.backend, collect_blocks, probe,
                self.fused, self.device, seed,
            )

        pending = {_submit(i, None): i for i in range(self.n_shards)}
        states: dict[int, ShardState] = {}
        pids: list[int] = []
        launches: dict[str, int] = {}
        reseeds = 0
        while pending:
            for fut in as_completed(list(pending)):
                i = pending.pop(fut)
                try:
                    pid, state, launched = fut.result()
                except ReplicaMissing:
                    # that worker has not seen this session yet: re-ship
                    # the replica (and staged-records path) to it once
                    reseeds += 1
                    pending[_submit(i, (self.replica, path))] = i
                    continue
                states[i] = state
                pids.append(pid)
                for k, n in launched.items():
                    launches[k] = launches.get(k, 0) + n
                if fold is not None:
                    fold(state)
        with self._lock:
            self._rounds += 1
            self._reseeds += reseeds
            self._seeded.update(pids)
            self._launches = launches
        return [states[i] for i in range(self.n_shards)]

    def close(self) -> None:
        """Release the staged temp file; the pool (shared) stays up and
        the workers' cached engines age out via the bounded session
        cache."""
        with self._lock:
            self._closed = True
            path, self._records_path = self._records_path, None
        if path is not None:
            _unlink_quiet(path)

    def __enter__(self) -> "ProcessShardSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _process_shard_worker(
    tree: FrozenQdTree,
    part: np.ndarray,
    shard_id: int,
    batch: int,
    backend: Optional[str],
    collect_blocks: bool,
    probe: Optional[ObservationProbe],
    fused: bool,
    device: str,
) -> ShardState:
    """Process-pool target: rebuild a ShardIngestor against the replica.

    Runs in a spawn-context worker with no shared state: the tree replica,
    the shard's record slice, and the (pure-numpy) probe all arrive by
    pickle; only the ShardState ships back.  Plans are warmed before the
    timed run.
    """
    engine = _worker_engine(tree, device)
    if fused:
        engine.warm_ingest(
            warm_sizes(part.shape[0], 1, batch), backend=backend
        )
    else:
        for s in sorted(warm_sizes(part.shape[0], 1, batch)):
            engine.route(
                np.zeros((s, tree.leaf_lo.shape[1]), np.int32),
                backend=backend,
            )
    ingestor = ShardIngestor(
        engine, shard_id=shard_id, backend=backend,
        collect_blocks=collect_blocks, probe=probe, fused=fused,
    )
    return ingestor.run(micro_batches(part, batch))


def sharded_ingest(
    layout: FrozenQdTree | LayoutEngine,
    records,
    n_shards: int,
    batch: int = 2048,
    executor: "Executor | str | None" = None,
    collect_blocks: bool = False,
    buffers=None,  # data.blocks.BlockBuffers | None
    tighten: bool = True,
    backend: Optional[str] = None,
    lock=None,  # context manager guarding the publish step
    observe=None,  # Workload | WorkloadTensors | ObservationProbe | None
    publish_check=None,  # Callable[[], bool], evaluated under ``lock``
    fused: bool = True,
    session: Optional[ProcessShardSession] = None,
    keep_state: bool = False,
) -> ShardedIngestReport:
    """Shard ``records`` across parallel ingestors and merge associatively.

    Contiguously splits the stream (a numpy array, or an int32 tensor on
    the engine's device) into ``n_shards``, runs one
    :class:`ShardIngestor` per shard on ``executor``, folds the resulting
    ShardStates through a :class:`MergeCoordinator`, and (when
    ``tighten``) publishes the merged tightening — bit-identical to
    ``LayoutEngine.ingest`` over the same records for every k.  With
    ``tighten=False`` the tree is left untouched (same contract as
    ``ingest``): buffers still fill and the merged counts/partials are
    still computed and reported.

    With ``observe`` set, one :class:`ObservationProbe` is built from the
    engine's plan and replicated to every shard; the merged Eq. 1
    window-stat partial lands in ``report.observation`` — bit-identical to
    the single-stream ``ingest(observe=...)`` totals.

    ``publish_check`` guards against publishing into a tree that was
    hot-swapped out mid-run: it is evaluated under ``lock`` immediately
    before the tightening is applied, and if it returns False the publish
    is skipped and the report carries ``stale_generation=True``.
    ``keep_state=True`` attaches the merged :class:`ShardState` to
    ``report.state``.

    ``executor`` selects the pool; ``None`` resolves via
    :func:`resolve_executor` on the engine's device.  ``"process"`` runs
    spawn-context workers of the RESIDENT module pool against a
    :class:`ProcessShardSession` replica on the engine's device (pass
    ``session=`` to reuse a seeded session across runs; with a staged
    session, ``records`` may be None).  ``"thread"`` shares the live
    engine's plans; on a GPU each shard runs under its own CUDA stream,
    after the stream current at this call.  A ``ProcessPoolExecutor``
    instance keeps the per-task replica shipping; any other ``Executor``
    instance drives the shared-plan ``.map`` protocol.  A failing shard
    raises here.

    The parent folds ShardStates AS THEY COMPLETE (``as_completed``
    streaming into the MergeCoordinator); the fold commutes bit-exactly,
    so completion order cannot change the published result.
    """
    engine = (
        layout if isinstance(layout, LayoutEngine) else engine_for(layout)
    )
    if session is not None:
        if (
            session.n_shards != n_shards
            or session.batch != batch
            or session.fused != fused
            or session.engine.tree is not engine.tree
        ):
            raise ValueError(
                "session does not match this run's tree/shards/batch/fused"
            )
        executor = "process"
    else:
        executor = resolve_executor(executor, n_shards,
                                    device=engine.device)
    if buffers is not None:
        collect_blocks = True
    builds0 = planlib.build_counts()
    probe = (
        engine.observation_probe(observe, backend=backend)
        if observe is not None
        else None
    )
    coordinator = MergeCoordinator(engine.tree)
    t0 = time.perf_counter()
    if executor == "process" and session is None:
        session_own = ProcessShardSession(
            engine, n_shards, batch=batch, backend=backend, fused=fused
        )
    else:
        session_own = None
    if executor == "process":
        sess = session if session is not None else session_own
        try:
            states = sess.round(
                records, collect_blocks=collect_blocks, probe=probe,
                fold=coordinator.add,
            )
        finally:
            if session_own is not None:
                session_own.close()
    elif isinstance(executor, ProcessPoolExecutor):
        # stateless shape: the replica ships with every task
        replica = replicate_tree(engine.tree)
        shard_parts = shard_slices(as_host(records), n_shards)
        args = [
            (replica, shard_parts[i], i, batch, backend, collect_blocks,
             probe, fused, str(engine.device))
            for i in range(n_shards)
        ]
        states = [
            f.result()
            for f in [
                executor.submit(_process_shard_worker, *a) for a in args
            ]
        ]
        for state in states:
            coordinator.add(state)
    else:
        source = None
        if engine.device.type == "cuda":
            # the shards' plan is built, and its operands uploaded, on the
            # calling stream, which every shard's stream waits for
            engine._backend(backend).accumulator(
                engine.tree, engine.plans, engine.device)
            source = torch.cuda.current_stream(engine.device)
        shard_parts = shard_slices(records, n_shards)
        ingestors = [
            ShardIngestor(
                engine, shard_id=i, backend=backend,
                collect_blocks=collect_blocks, probe=probe, fused=fused,
                source_stream=source,
            )
            for i in range(n_shards)
        ]
        shard_batches = [micro_batches(part, batch) for part in shard_parts]
        if executor == "thread":
            by_shard: dict[int, ShardState] = {}
            with ThreadPoolExecutor(max_workers=n_shards) as pool:
                futs = {
                    pool.submit(_run_shard, ing, b): i
                    for i, (ing, b) in enumerate(
                        zip(ingestors, shard_batches)
                    )
                }
                for fut in as_completed(futs):
                    state = fut.result()
                    by_shard[futs[fut]] = state
                    coordinator.add(state)
            states = [by_shard[i] for i in range(n_shards)]
        else:
            # custom Executor instances keep the .map protocol
            states = list(
                executor.map(_run_shard, ingestors, shard_batches)
            )
            for state in states:
                coordinator.add(state)
    t_merge = time.perf_counter()
    published = stale = False
    if tighten:
        # publish under the caller's lock; re-check liveness there — the
        # tree may have been hot-swapped out while the shards were routing
        with (lock if lock is not None else contextlib.nullcontext()):
            if publish_check is None or publish_check():
                sizes = coordinator.publish(buffers=buffers)
                published = True
            else:
                stale = True
    if not published:
        if buffers is not None:
            coordinator.fill_buffers(buffers)
        sizes = coordinator.merged.counts.copy()
    t1 = time.perf_counter()
    merged = coordinator.merged
    return ShardedIngestReport(
        n_batches=merged.n_batches,
        n_records=merged.n_records,
        block_sizes=sizes,
        wall_s=t1 - t0,
        backend=backend or engine.backend,
        plan_cache=engine.plans.stats(),
        builds=planlib.build_delta(builds0, planlib.build_counts()),
        observation=merged.obs if probe is not None else None,
        fused=fused,
        n_shards=n_shards,
        shard_wall_s=tuple(s.wall_s for s in states),
        merge_s=t1 - t_merge,
        published=published,
        stale_generation=stale,
        state=merged if keep_state else None,
    )


def replicate_tree(tree: FrozenQdTree) -> FrozenQdTree:
    """A routing-identical replica with private leaf descriptions.

    The copy a shard host (or a what-if run) would hold: topology and cut
    table are shared (immutable), leaf descriptions are cloned so the
    replica can be tightened without touching the original.  The replica
    gets its own tree signature, hence its own plan-cache entries.  It
    also copies the port's ``block_sizes`` (the last tightening's counts),
    which the JAX package's tree does not have.
    """
    return FrozenQdTree(
        schema=tree.schema,
        cuts=tree.cuts,
        cut_id=tree.cut_id.copy(),
        left=tree.left.copy(),
        right=tree.right.copy(),
        leaf_bid=tree.leaf_bid.copy(),
        leaf_lo=tree.leaf_lo.copy(),
        leaf_hi=tree.leaf_hi.copy(),
        leaf_cat=tree.leaf_cat.copy(),
        leaf_adv=tree.leaf_adv.copy(),
        depth=tree.depth,
        block_sizes=(None if tree.block_sizes is None
                     else tree.block_sizes.copy()),
    )


def states_bit_identical(a: ShardState, b: ShardState) -> bool:
    """True iff two states' tightening aggregates are bit-identical."""
    return (
        bool(np.array_equal(a.counts, b.counts))
        and bool(np.array_equal(a.lo, b.lo))
        and bool(np.array_equal(a.hi, b.hi))
        and bool(np.array_equal(a.cat, b.cat))
        and bool(np.array_equal(a.adv, b.adv))
    )


__all__ = [
    "CUDA_DEFAULT_EXECUTOR",
    "MergeCoordinator",
    "PerformanceWarning",
    "ProcessShardSession",
    "ReplicaMissing",
    "ShardIngestor",
    "ShardState",
    "ShardedIngestReport",
    "micro_batches",
    "process_pool",
    "replicate_tree",
    "resolve_executor",
    "shard_slices",
    "sharded_ingest",
    "shutdown_process_pool",
    "states_bit_identical",
    "warm_sizes",
]
