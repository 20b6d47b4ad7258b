"""Workload auto-detection: infer the live query mix from the serving path.

The qd-tree is only as good as the workload it is scored against (paper
Eq. 1), and until now that workload was *declared* by an operator.  Online
reorganization systems (OReO's worst-case-bounded layout adaptation,
Hyrise's automatic clustering) instead observe the actual query stream.
This module closes that loop:

* every served query's predicate structure is canonicalized into a
  *signature* — per conjunct, the tensorized box/categorical/advanced form
  reduced to ``(column, op, cut-bucketed bound)`` atoms, so textually
  different but semantically near-identical queries share a key;
* :class:`TrackerState` is a pure-numpy, serializable frequency sketch over
  those signatures with **exponential recency decay**.  Counts are exact
  int64 per *generation* (a serving round); decay is applied only at
  inference time as ``count[g] * decay**age``.  Because the stored partials
  are exact integers, ``merge`` (align generations, elementwise add) is
  associative *and* commutative bit-identically — k serving shards fold to
  exactly the single-stream state, the same algebra as
  :class:`~repro_torch.engine.sharded.ShardState` and
  :class:`~repro_torch.engine.engine.WindowStat` — and ``tick`` (advance one
  generation) is a homomorphism: ``tick(a.merge(b)) == tick(a).merge(tick(b))``;
* :meth:`WorkloadTracker.infer_workload` materializes the decayed top-k
  signatures back into a **weighted** :class:`~repro_torch.core.query.Workload`
  (weights expressed as deterministic integer multiplicities over a fixed
  query budget, so the result is a plain Workload usable everywhere a
  declared one is today — ``build_layout``, ``skip_stats``,
  ``LayoutEngine.ingest(observe=...)`` — with the exact-int Eq. 1
  accounting intact).

``LayoutEngine.route_queries(..., track=tracker)`` and
``LayoutService.serve`` feed the tracker from the serving path;
``AutoRebuilder(workload="auto", tracker=tracker)`` scores drift and
rebuilds against the *inferred* mix (re-inferred at trigger time).  See
``benchmarks/workload_tracking.py`` for the acceptance gate.
"""

from __future__ import annotations

# qdlint: deterministic-module

import ast
import dataclasses
import threading
from typing import Iterable, Optional, Sequence

import numpy as np

from repro_torch.core import predicates as preds
from repro_torch.core import query as qry
from repro_torch.core.predicates import OP_EQ, OP_GE, OP_GT, OP_LE, OP_LT, Schema
from repro_torch.core.query import AdvAtom, InAtom, Query, RangeAtom

# Signature atom tags (first element of every atom tuple).
SIG_RANGE = 0  # (SIG_RANGE, dim, OP_GE|OP_LT, bucketed_bound)
SIG_IN = 1  # (SIG_IN, dim, *sorted_values)
SIG_ADV = 2  # (SIG_ADV, col_a, op, col_b, polarity)


# ---------------------------------------------------------------------------
# Canonical predicate signatures
# ---------------------------------------------------------------------------
def bucket_lo(v: int, dom: int, n_buckets: int) -> int:
    """Largest bucket edge ``<= v``.

    Both directions share ONE edge set ``e_j = j * dom // n_buckets``
    (strictly increasing for ``n_buckets <= dom``), so bucketed bounds are
    fixed points: re-canonicalizing an inferred query reproduces its
    signature exactly.
    """
    if n_buckets >= dom:
        return int(v)
    # largest j with e_j <= v:  j*dom//B <= v  <=>  j*dom < (v+1)*B
    j = ((int(v) + 1) * n_buckets - 1) // dom
    return min(j, n_buckets) * dom // n_buckets


def bucket_hi(v: int, dom: int, n_buckets: int) -> int:
    """Smallest bucket edge ``>= v`` — upper bounds round *outward* so the
    bucketed conjunct always covers the observed one (conservative)."""
    if n_buckets >= dom:
        return int(v)
    # smallest j with e_j >= v:  j*dom//B >= v  <=>  j >= ceil(v*B/dom)
    j = (int(v) * n_buckets + dom - 1) // dom
    return min(j, n_buckets) * dom // n_buckets


def _conjunct_signature(
    lo: Sequence[int],
    hi: Sequence[int],
    cat_values: dict[int, tuple[int, ...]],
    adv_req: dict[tuple[int, int, int], bool],
    schema: Schema,
    n_buckets: int,
) -> tuple:
    """One conjunct's canonical atom set, sorted for order independence.

    ``lo``/``hi`` are the conjunct's numeric box (hi exclusive, tensorize
    semantics); ``cat_values`` maps constrained categorical dims to their
    allowed values; ``adv_req`` maps advanced predicates to the required
    polarity.  Bounds are quantized to ``n_buckets`` edges per column —
    the "cut bucket" that makes the sketch finite — and atoms that bucket
    to the trivial full-domain constraint are dropped.
    """
    doms = schema.doms
    is_cat = schema.is_categorical
    atoms: list[tuple] = []
    for d in range(schema.ndims):
        if is_cat[d]:
            continue
        dom = int(doms[d])
        if lo[d] > 0:
            e = bucket_lo(int(lo[d]), dom, n_buckets)
            if e > 0:
                atoms.append((SIG_RANGE, d, OP_GE, e))
        if hi[d] < dom:
            e = bucket_hi(int(hi[d]), dom, n_buckets)
            if e < dom:
                atoms.append((SIG_RANGE, d, OP_LT, e))
    for d, vals in cat_values.items():
        atoms.append((SIG_IN, d) + tuple(vals))
    for (ca, op, cb), pol in adv_req.items():
        atoms.append((SIG_ADV, ca, op, cb, int(pol)))
    return tuple(sorted(atoms))


# Per-query signature memo.  Serving paths repeat the same Query OBJECTS
# (dashboards, Zipf-skewed mixes reuse workload templates), and
# canonicalization is pure given (query, n_buckets, adv_filter) — so the
# atom fold runs once per distinct key.  This is what keeps the
# result-cache HIT path (exact signatures) and the tracker's per-dispatch
# recording (sketch signatures) off the serving critical path.  Keys use
# ``id(query)`` rather than the query's (recomputed-per-call) dataclass
# hash; each entry holds a strong reference to its query so the id cannot
# be recycled while the entry lives.  Dict get/set are GIL-atomic; a
# racing recompute writes the same value.  On overflow the memo is simply
# cleared: one-shot query floods cannot grow it without bound, and the
# hot set re-memoizes in one dispatch.  Fresh-but-equal query objects
# miss the memo and just recompute — correctness never depends on a hit.
_SIG_MEMO: dict[tuple, tuple] = {}
_SIG_MEMO_MAX = 65_536

# Same id-keyed pattern for the cut table's advanced-atom filter: one
# frozenset per CutTable object (frozensets cache their hash, so reusing
# the object also makes the _SIG_MEMO key lookups cheap).
_ADV_FILTER_MEMO: dict[int, tuple] = {}


def adv_filter_for(cuts) -> Optional[frozenset]:
    """The ``(col_a, op, col_b)`` filter for a cut table, memoized."""
    if cuts is None:
        return None
    memoized = _ADV_FILTER_MEMO.get(id(cuts))
    if memoized is not None:
        return memoized[1]
    f = frozenset((a.col_a, a.op, a.col_b) for a in cuts.adv)
    if len(_ADV_FILTER_MEMO) >= 1024:
        _ADV_FILTER_MEMO.clear()
    _ADV_FILTER_MEMO[id(cuts)] = (cuts, f)
    return f


def query_signatures(
    workload: qry.Workload,
    n_buckets: int,
    adv_filter: Optional[frozenset] = None,
) -> list[tuple]:
    """Per-query canonical signatures, straight from the DNF atoms.

    Folds each conjunct's atoms into the same box/categorical/advanced
    form :meth:`Workload.tensorize` produces (min/max over range atoms,
    intersection over IN atoms, last-wins polarity for advanced atoms), so
    the signatures match :func:`query_signatures_from_tensors` over the
    tensorized workload.  ``adv_filter`` (a set of ``(col_a, op, col_b)``
    keys — the cut table's advanced predicates) restricts advanced atoms
    to those the tensorized hot path can see, so one query maps to ONE
    sketch key no matter which ``route_queries`` overload served it;
    ``None`` keeps every advanced atom (direct API use without a tree).
    """
    schema = workload.schema
    doms = schema.doms
    sigs: list[tuple] = []
    for q in workload.queries:
        memo_key = (id(q), id(schema), n_buckets, adv_filter)
        memoized = _SIG_MEMO.get(memo_key)
        if memoized is not None:
            sigs.append(memoized[2])
            continue
        conj_sigs = []
        for conj in q.conjuncts:
            lo = [0] * schema.ndims
            hi = [int(x) for x in doms]
            cats: dict[int, set] = {}
            adv: dict[tuple[int, int, int], bool] = {}
            for a in conj:
                if isinstance(a, RangeAtom):
                    if a.op == OP_LT:
                        hi[a.dim] = min(hi[a.dim], a.literal)
                    elif a.op == OP_LE:
                        hi[a.dim] = min(hi[a.dim], a.literal + 1)
                    elif a.op == OP_GT:
                        lo[a.dim] = max(lo[a.dim], a.literal + 1)
                    elif a.op == OP_GE:
                        lo[a.dim] = max(lo[a.dim], a.literal)
                    elif a.op == OP_EQ:
                        lo[a.dim] = max(lo[a.dim], a.literal)
                        hi[a.dim] = min(hi[a.dim], a.literal + 1)
                    else:
                        raise ValueError("OP_NE atoms unsupported")
                elif isinstance(a, InAtom):
                    vals = set(int(v) for v in a.values)
                    cats[a.dim] = (
                        cats[a.dim] & vals if a.dim in cats else vals
                    )
                else:
                    key = (a.col_a, a.op, a.col_b)
                    if adv_filter is None or key in adv_filter:
                        adv[key] = a.polarity
            cat_values = {
                d: tuple(sorted(vals))
                for d, vals in sorted(cats.items())
                if len(vals) < schema.columns[d].dom  # full set: trivial
            }
            conj_sigs.append(
                _conjunct_signature(lo, hi, cat_values, adv, schema,
                                    n_buckets)
            )
        sig = tuple(sorted(conj_sigs))
        if len(_SIG_MEMO) >= _SIG_MEMO_MAX:
            _SIG_MEMO.clear()
        # the value pins (query, schema) so the id-based key stays valid
        _SIG_MEMO[memo_key] = (q, schema, sig)
        sigs.append(sig)
    return sigs


def query_signatures_from_tensors(
    wt: qry.WorkloadTensors,
    schema: Schema,
    adv: tuple[preds.AdvPredicate, ...] = (),
    n_buckets: int = 256,
) -> list[tuple]:
    """Per-query signatures from an already-tensorized workload.

    The serving hot path hands the engine :class:`WorkloadTensors`; the
    conjunct rows there *are* the canonical form, so extraction is direct.
    ``adv`` (the cut table's advanced predicates) decodes ``q_adv`` column
    indices back to stable ``(col_a, op, col_b)`` keys — without it,
    advanced requirements are dropped from the signature.
    """
    doms = schema.doms
    off = schema.cat_offsets
    sigs_per_query: list[list[tuple]] = [[] for _ in range(wt.n_queries)]
    for c in range(wt.n_conjuncts):
        cat_values: dict[int, tuple[int, ...]] = {}
        for d in np.nonzero(schema.is_categorical)[0]:
            d = int(d)
            seg = slice(int(off[d]), int(off[d]) + schema.columns[d].dom)
            bits = wt.q_cat[c, seg]
            if not bits.all():
                cat_values[d] = tuple(int(v) for v in np.nonzero(bits)[0])
        adv_req: dict[tuple[int, int, int], bool] = {}
        for a_i, pred in enumerate(adv):
            req = int(wt.q_adv[c, a_i])
            if req != qry.ADV_ANY:
                adv_req[(pred.col_a, pred.op, pred.col_b)] = (
                    req == qry.ADV_TRUE
                )
        sig = _conjunct_signature(
            [int(x) for x in wt.q_lo[c]],
            [min(int(x), int(doms[d])) for d, x in enumerate(wt.q_hi[c])],
            cat_values, adv_req, schema, n_buckets,
        )
        sigs_per_query[int(wt.conj_query[c])].append(sig)
    return [tuple(sorted(s)) for s in sigs_per_query]


def query_from_signature(sig: tuple, schema: Schema) -> Query:
    """Materialize a representative query back from a signature."""
    conjuncts = []
    for conj_sig in sig:
        atoms: list = []
        for atom in conj_sig:
            tag = atom[0]
            if tag == SIG_RANGE:
                _, d, op, v = atom
                atoms.append(RangeAtom(int(d), int(op), int(v)))
            elif tag == SIG_IN:
                atoms.append(InAtom(int(atom[1]), tuple(atom[2:])))
            else:
                _, ca, op, cb, pol = atom
                atoms.append(AdvAtom(int(ca), int(op), int(cb), bool(pol)))
        conjuncts.append(atoms)
    return Query.disjunction(conjuncts)


def apportion_conjunct_budget(
    items: list[tuple[tuple, float]], budget: int
) -> tuple[list[tuple[tuple, float]], list[int]]:
    """Integer multiplicities filling ``budget`` conjunct slots toward
    each signature's weight-proportional share.

    ``items`` is ``[(signature, weight), ...]`` heaviest-first.  Every
    signature whose single copy fits is kept with >= 1 copy (heaviest
    first); remaining slots fill largest-deficit-first (index breaks
    ties) until no signature fits — so the conjunct count always lands
    in ``(budget - max_cost, budget]`` and successive materializations
    reuse ONE padded compilation.  Returns the kept items and their
    multiplicities.  Shared by :meth:`TrackerState.infer_workload` and
    the replica clustering's per-cluster mixes
    (``repro_torch.service.replica``) so both produce the same stable tensor
    geometry.
    """
    costs = [max(len(sig), 1) for sig, _ in items]
    # heaviest-first: keep every signature whose single copy fits
    kept, used = [], 0
    for (sig, w), c in zip(items, costs):
        if used + c <= budget:
            kept.append((sig, w, c))
            used += c
    if not kept:  # even the heaviest alone exceeds the budget
        kept, used = [items[0] + (costs[0],)], costs[0]
    items = [(s, w) for s, w, _ in kept]
    costs = [c for _, _, c in kept]
    total_w = sum(w for _, w in items) or 1.0
    mults = [1] * len(items)
    remaining = budget - used
    # fill the remaining conjunct slots toward weight-proportional
    # shares (largest deficit first; index breaks ties) until no
    # signature fits — the bucket-stability guarantee
    while True:
        best = None
        for i, c in enumerate(costs):
            if c > remaining:
                continue
            deficit = (
                items[i][1] / total_w * budget - mults[i] * c
            )
            key = (deficit, -i)
            if best is None or key > best[0]:
                best = (key, i)
        if best is None:
            break
        mults[best[1]] += 1
        remaining -= costs[best[1]]
    return items, mults


# ---------------------------------------------------------------------------
# The sketch
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Sketch geometry + inference defaults for :class:`WorkloadTracker`.

    n_buckets     bound-quantization buckets per column (the "cut bucket"
                  of a signature atom); bounds snap outward to bucket
                  edges, so larger values track the live mix more exactly
                  at the cost of more distinct keys.
    n_gens        generations retained; an observation older than this has
                  exactly zero weight (the ring simply forgets it).
    decay         per-generation exponential decay applied at *inference*
                  time (stored counts stay exact ints).
    max_keys      soft sketch bound: after a tick, if more keys than this
                  survive, the lowest-weight keys are pruned.  Pruning is
                  lossy maintenance and excluded from the merge-identity
                  contract (shards prune independently); size workloads so
                  it never fires in steady state.
    infer_top_k   distinct signatures an inferred workload materializes.
    infer_budget  *conjunct* slots an inferred workload fills — weights
                  become integer multiplicities packed toward this
                  budget, so inferred workloads have a fixed tensorized
                  geometry (DNF mixes included).
    """

    n_buckets: int = 256
    n_gens: int = 32
    decay: float = 0.5
    max_keys: int = 65536
    infer_top_k: int = 16
    infer_budget: int = 64

    def __post_init__(self):
        if self.n_buckets < 1:
            raise ValueError("n_buckets must be >= 1")
        if self.n_gens < 1:
            raise ValueError("n_gens must be >= 1")
        if not 0.0 < self.decay <= 1.0:
            raise ValueError("decay must be in (0, 1]")
        if self.infer_top_k < 1 or self.infer_budget < 1:
            raise ValueError("infer_top_k / infer_budget must be >= 1")
        if self.max_keys < 1:
            raise ValueError("max_keys must be >= 1")


@dataclasses.dataclass
class TrackerState:
    """Frequency-decayed signature sketch: exact ints, associative merge.

    ``counts[sig]`` is a ``(n_gens,) int64`` ring — index ``g`` holds the
    number of times ``sig`` was served ``g`` generations ago.  All
    mutation is integer addition and shifting, so:

    * :meth:`merge` (align generations, add elementwise) is associative
      and commutative bit-identically — shard-local states fold to exactly
      the single-stream state in any order/association;
    * :meth:`tick` commutes with merge (shift-then-add == add-then-shift),
      so per-round splits across serving shards stay bit-identical as
      long as every query lands in the same generation it would have in
      the single stream;
    * recording within one generation is order-independent (addition
      commutes), which is the decay order-independence contract.

    Decay enters only in :meth:`weights` (``counts @ decay**age``), a
    deterministic function of the exact state.  Pure numpy + builtins:
    pickles for thread/process pools, :meth:`save`/:meth:`load` round-trip
    through npz for cross-host shipping.
    """

    decay: float
    n_gens: int
    n_buckets: int
    generation: int = 0
    counts: dict[tuple, np.ndarray] = dataclasses.field(default_factory=dict)
    queries_seen: int = 0

    @staticmethod
    def fresh(config: TrackerConfig) -> "TrackerState":
        return TrackerState(
            decay=config.decay,
            n_gens=config.n_gens,
            n_buckets=config.n_buckets,
        )

    @property
    def n_keys(self) -> int:
        return len(self.counts)

    # -- recording -----------------------------------------------------------
    def add(self, sigs: Iterable[tuple], weight: int = 1) -> None:
        """Count served-query signatures into the current generation."""
        w = int(weight)
        for sig in sigs:
            arr = self.counts.get(sig)
            if arr is None:
                arr = np.zeros(self.n_gens, np.int64)
                self.counts[sig] = arr
            arr[0] += w
            self.queries_seen += w

    @staticmethod
    def _shift(arr: np.ndarray, n: int, n_gens: int) -> np.ndarray:
        if n <= 0:
            return arr
        out = np.zeros(n_gens, np.int64)
        if n < n_gens:
            out[n:] = arr[: n_gens - n]
        return out

    def tick(self, n: int = 1) -> None:
        """Advance ``n`` generations: everything recorded so far ages by
        ``n`` decay steps; observations older than ``n_gens`` drop to
        exactly zero (and their keys are forgotten)."""
        if n < 0:
            raise ValueError("tick must be >= 0")
        if n == 0:
            return
        self.generation += n
        aged = {}
        for sig, arr in self.counts.items():
            out = self._shift(arr, n, self.n_gens)
            if out.any():
                aged[sig] = out
        self.counts = aged

    # -- the algebra ---------------------------------------------------------
    def _check_compatible(self, other: "TrackerState") -> None:
        if (
            self.decay != other.decay
            or self.n_gens != other.n_gens
            or self.n_buckets != other.n_buckets
        ):
            raise ValueError(
                "cannot merge tracker states with different configs"
            )

    def merge(self, other: "TrackerState") -> "TrackerState":
        """Associative, commutative fold of two sketches (exact ints).

        States are aligned to the newer generation (the older one's
        counts age by the difference first), then added elementwise.
        """
        self._check_compatible(other)
        g = max(self.generation, other.generation)
        out: dict[tuple, np.ndarray] = {}
        for state in (self, other):
            shift = g - state.generation
            for sig, arr in state.counts.items():
                aged = self._shift(arr, shift, self.n_gens)
                if not aged.any():
                    continue
                cur = out.get(sig)
                out[sig] = aged.copy() if cur is None else cur + aged
        return TrackerState(
            decay=self.decay,
            n_gens=self.n_gens,
            n_buckets=self.n_buckets,
            generation=g,
            counts=out,
            queries_seen=self.queries_seen + other.queries_seen,
        )

    def equals(self, other: "TrackerState") -> bool:
        """Exact (bit-identical) state equality, key-order independent."""
        return (
            self.decay == other.decay
            and self.n_gens == other.n_gens
            and self.n_buckets == other.n_buckets
            and self.generation == other.generation
            and self.queries_seen == other.queries_seen
            and set(self.counts) == set(other.counts)
            and all(
                np.array_equal(arr, other.counts[sig])
                for sig, arr in self.counts.items()
            )
        )

    def copy(self) -> "TrackerState":
        return TrackerState(
            decay=self.decay,
            n_gens=self.n_gens,
            n_buckets=self.n_buckets,
            generation=self.generation,
            counts={sig: arr.copy() for sig, arr in self.counts.items()},
            queries_seen=self.queries_seen,
        )

    # -- inference -----------------------------------------------------------
    def weights(self) -> dict[tuple, float]:
        """Decayed weight per signature: ``counts @ decay**age``."""
        powers = np.power(
            np.float64(self.decay), np.arange(self.n_gens, dtype=np.float64)
        )
        return {
            sig: float(arr.astype(np.float64) @ powers)
            for sig, arr in self.counts.items()
        }

    def top_signatures(self, top_k: int) -> list[tuple[tuple, float]]:
        """Heaviest ``top_k`` signatures, deterministically ordered
        (weight descending, signature ascending as the tie-break)."""
        items = [(s, w) for s, w in self.weights().items() if w > 0.0]
        items.sort(key=lambda it: (-it[1], it[0]))
        return items[:top_k]

    def prune(self, max_keys: int) -> int:
        """Keep only the heaviest ``max_keys`` keys (lossy maintenance;
        NOT part of the merge-identity algebra).  Returns keys dropped."""
        if len(self.counts) <= max_keys:
            return 0
        keep = {sig for sig, _ in self.top_signatures(max_keys)}
        dropped = [sig for sig in self.counts if sig not in keep]
        for sig in dropped:
            del self.counts[sig]
        return len(dropped)

    def infer_workload(
        self,
        schema: Schema,
        top_k: int = 16,
        budget: Optional[int] = 64,
    ) -> qry.Workload:
        """Materialize the decayed top-k mix as a weighted Workload.

        With ``budget`` set, weights become integer multiplicities filling
        ``budget`` *conjunct* slots toward each signature's
        weight-proportional share (every signature that fits gets >= 1
        copy; heavier ones get more).  Budgeting conjuncts — the unit the
        query backends pad and compile — rather than queries pins the
        tensorized geometry: the fill stops only when no signature fits
        the remainder, so the conjunct count always lands in
        ``(budget - max_cost, budget]`` for successive inferences of a
        DNF-bearing mix.  Weighting by repetition keeps Eq. 1 accounting
        exact-int everywhere.  With ``budget=None`` each signature
        appears once.  Deterministic for a fixed state.  Empty state ->
        empty Workload (callers skip observation until queries have been
        served).
        """
        items = self.top_signatures(top_k)
        if not items:
            return qry.Workload(schema, ())
        if budget is None:
            mults = [1] * len(items)
        else:
            items, mults = apportion_conjunct_budget(items, int(budget))
        queries: list[Query] = []
        for (sig, _), m in zip(items, mults):
            queries.extend([query_from_signature(sig, schema)] * m)
        return qry.Workload(schema, tuple(queries))

    # -- serialization (cross-host shipping) ---------------------------------
    def save(self, path: str) -> None:
        keys = sorted(self.counts)
        arrays = {
            "keys": np.asarray([repr(k) for k in keys], dtype=np.str_),
            "counts": (
                np.stack([self.counts[k] for k in keys])
                if keys
                else np.zeros((0, self.n_gens), np.int64)
            ),
            "meta": np.asarray(
                [self.n_gens, self.n_buckets, self.generation,
                 self.queries_seen],
                np.int64,
            ),
            "decay": np.asarray(self.decay, np.float64),
        }
        np.savez_compressed(path, **arrays)

    @staticmethod
    def load(path: str) -> "TrackerState":
        z = np.load(path, allow_pickle=False)
        meta = z["meta"]
        counts_mat = z["counts"]
        counts = {
            ast.literal_eval(str(key)): counts_mat[i].astype(np.int64)
            for i, key in enumerate(z["keys"])
        }
        return TrackerState(
            decay=float(z["decay"]),
            n_gens=int(meta[0]),
            n_buckets=int(meta[1]),
            generation=int(meta[2]),
            counts=counts,
            queries_seen=int(meta[3]),
        )


def merge_states(states: Iterable[TrackerState]) -> TrackerState:
    """Fold shard-local tracker states (any order — the merge commutes)."""
    it = iter(states)
    try:
        acc = next(it).copy()
    except StopIteration:
        raise ValueError("no tracker states to merge") from None
    for s in it:
        acc = acc.merge(s)
    return acc


# ---------------------------------------------------------------------------
# The serving-path facade
# ---------------------------------------------------------------------------
class WorkloadTracker:
    """Thread-safe tracker the serving path records into.

    One tracker per serving thread/shard is the scalable deployment
    (record is a dict update under a short lock); states fold through
    :func:`merge_states` exactly like ShardStates.  ``tick()`` closes a
    serving round (one decay generation) — drive it from
    :meth:`LayoutService.serve` or any external cadence.  ``version``
    bumps on every mutation, so inference results can be cached per
    version (``infer_workload`` does this internally).
    """

    def __init__(
        self,
        schema: Schema,
        config: Optional[TrackerConfig] = None,
        state: Optional[TrackerState] = None,
    ):
        self.schema = schema
        self.config = config or TrackerConfig()
        self.state = (  # guarded by: self._lock
            state if state is not None else TrackerState.fresh(self.config)
        )
        self._lock = threading.Lock()
        self._version = 0  # guarded by: self._lock
        self._infer_cache: Optional[tuple] = None  # guarded by: self._lock

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    @property
    def queries_seen(self) -> int:
        with self._lock:
            return self.state.queries_seen

    # -- recording (the route_queries/route_query hook) ----------------------
    def record(
        self,
        workload: "qry.Workload | qry.WorkloadTensors",
        cuts: Optional[preds.CutTable] = None,
        weight: int = 1,
    ) -> int:
        """Record one served workload's query signatures; returns how many
        queries were recorded.  Accepts either a :class:`Workload` (atoms
        canonicalized directly) or the already-tensorized
        :class:`WorkloadTensors` the engine serves from (``cuts`` decodes
        its advanced-predicate columns).  Signature extraction runs
        outside the lock; only the integer fold holds it.
        """
        if isinstance(workload, qry.WorkloadTensors):
            sigs = query_signatures_from_tensors(
                workload, self.schema,
                adv=cuts.adv if cuts is not None else (),
                n_buckets=self.config.n_buckets,
            )
        else:
            # with a cut table in hand, restrict advanced atoms to it —
            # the tensorized overload cannot see non-cut adv atoms, and a
            # query must map to one key regardless of serving overload
            sigs = query_signatures(
                workload, self.config.n_buckets,
                adv_filter=adv_filter_for(cuts),
            )
        with self._lock:
            self.state.add(sigs, weight=weight)
            self._version += 1
        return len(sigs)

    def tick(self, n: int = 1) -> None:
        """Close a serving round: age every recorded signature by ``n``
        decay generations (and prune past the soft key bound)."""
        with self._lock:
            self.state.tick(n)
            self.state.prune(self.config.max_keys)
            self._version += 1

    def merge_state(self, other: TrackerState) -> None:
        """Fold a remote/shard-local state into this tracker."""
        with self._lock:
            self.state = self.state.merge(other)
            self._version += 1

    def snapshot(self) -> TrackerState:
        """Consistent copy of the sketch (for shipping or inspection)."""
        with self._lock:
            return self.state.copy()

    def drain_state(self) -> TrackerState:
        """Take the accumulated sketch and reset this tracker to empty.

        The worker-side half of a distributed fold: a serving worker
        records locally, then periodically drains and ships the delta to
        whoever merges the states.  The drained state keeps its generation — ``merge`` aligns states
        to the newer generation — so drain cadence cannot change the
        folded bits: any partition of the recorded stream into deltas
        merges to the same sketch as recording it all in one tracker.
        """
        with self._lock:
            state = self.state
            self.state = TrackerState(
                decay=state.decay,
                n_gens=state.n_gens,
                n_buckets=state.n_buckets,
                generation=state.generation,
            )
            self._version += 1
            return state

    # -- inference -----------------------------------------------------------
    def infer_workload(
        self,
        top_k: Optional[int] = None,
        budget: Optional[int] = None,
    ) -> qry.Workload:
        """The live mix as a weighted Workload (see
        :meth:`TrackerState.infer_workload`); cached per tracker version so
        repeated drift probes between serving rounds re-infer nothing."""
        k = self.config.infer_top_k if top_k is None else top_k
        b = self.config.infer_budget if budget is None else budget
        with self._lock:
            cached = self._infer_cache
            if cached is not None and cached[:3] == (self._version, k, b):
                return cached[3]
            wl = self.state.infer_workload(self.schema, top_k=k, budget=b)
            self._infer_cache = (self._version, k, b, wl)
            return wl

    def top_signatures(self, top_k: Optional[int] = None):
        """Heaviest signatures with their decayed weights (introspection)."""
        k = self.config.infer_top_k if top_k is None else top_k
        with self._lock:
            return self.state.top_signatures(k)

    def describe(self, top_k: int = 8) -> list[str]:
        """Human-readable top of the sketch (CLI/debugging)."""
        out = []
        for sig, w in self.top_signatures(top_k):
            parts = []
            for conj in sig:
                ats = []
                for atom in conj:
                    if atom[0] == SIG_RANGE:
                        _, d, op, v = atom
                        sym = ">=" if op == OP_GE else "<"
                        ats.append(
                            f"{self.schema.columns[d].name} {sym} {v}"
                        )
                    elif atom[0] == SIG_IN:
                        ats.append(
                            f"{self.schema.columns[atom[1]].name} IN "
                            f"{list(atom[2:])}"
                        )
                    else:
                        _, ca, op, cb, pol = atom
                        opn = {0: "<", 1: "<=", 2: ">", 3: ">=", 4: "==",
                               5: "!="}[op]
                        pred = (
                            f"{self.schema.columns[ca].name} {opn} "
                            f"{self.schema.columns[cb].name}"
                        )
                        ats.append(pred if pol else f"NOT({pred})")
                parts.append(" AND ".join(ats) if ats else "TRUE")
            out.append(f"w={w:.3f}  " + " OR ".join(parts))
        return out


__all__ = [
    "SIG_ADV",
    "SIG_IN",
    "SIG_RANGE",
    "TrackerConfig",
    "TrackerState",
    "WorkloadTracker",
    "apportion_conjunct_budget",
    "bucket_hi",
    "bucket_lo",
    "merge_states",
    "query_from_signature",
    "query_signatures",
    "query_signatures_from_tensors",
]
