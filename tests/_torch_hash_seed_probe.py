"""Subprocess probe: sections 1–4 of ``_hash_seed_probe.py`` through the
port, the merge and signature paths that must not depend on the hash
seed (section 5, the coordinator's folds, runs in
``test_torch_coordinator.py``).

    python tests/_torch_hash_seed_probe.py [repro_torch|repro]

prints one sha256 over: the plan counters' delta (``build_delta`` in the
port, ``trace_delta`` in the JAX package), a k-way ``TrackerState`` merge
with ``top_signatures`` and ``infer_workload``, the replica
``signature_features`` of the merged signatures, and a k-way
``ShardState`` merge.  ``tests/test_torch_hash_determinism.py`` runs it
under several ``PYTHONHASHSEED`` values and through both packages: str-
keyed set iteration order is what hash randomization perturbs, and these
outputs cross process boundaries in the spawn-worker fleet.
"""

import hashlib
import importlib
import sys

import numpy as np


def digest(pkg: str) -> str:
    h = hashlib.sha256()

    # 1. the plan counters' delta: a str-keyed counter diff
    plan = importlib.import_module(f"{pkg}.engine.plan")
    delta = plan.build_delta if pkg == "repro_torch" else plan.trace_delta
    before = {f"counter_{i}": i for i in range(20)}
    after = {f"counter_{i}": i * 2 for i in range(5, 25)}
    h.update(repr(delta(before, after)).encode())

    # 2. k-way TrackerState merge + inference
    qry = importlib.import_module(f"{pkg}.core.query")
    pred = importlib.import_module(f"{pkg}.core.predicates")
    tracker = importlib.import_module(f"{pkg}.service.tracker")
    schema = pred.Schema((
        pred.Column("a", "numeric", 1000),
        pred.Column("b", "numeric", 1000),
        pred.Column("c", "categorical", 6),
    ))

    def workload(seed: int):
        rng = np.random.default_rng(seed)
        queries = []
        for _ in range(6):
            d = int(rng.integers(0, 2))
            lo = int(rng.integers(0, 900))
            atoms = [qry.RangeAtom(d, pred.OP_GE, lo),
                     qry.RangeAtom(d, pred.OP_LT, lo + 50)]
            if rng.random() < 0.5:
                vals = rng.choice(6, size=2, replace=False)
                atoms.append(qry.InAtom(2, tuple(int(v)
                                                 for v in sorted(vals))))
            queries.append(qry.Query.conjunction(atoms))
        return qry.Workload(schema, tuple(queries))

    cfg = tracker.TrackerConfig(n_buckets=64, n_gens=8, decay=0.5)
    trackers = [tracker.WorkloadTracker(schema, cfg) for _ in range(4)]
    for i, t in enumerate(trackers):
        t.record(workload(100 + i))
        t.tick()
        t.record(workload(200 + i))
    merged = tracker.merge_states([t.snapshot() for t in trackers])
    tops = merged.top_signatures(16)
    h.update(repr(tops).encode())
    inferred = merged.infer_workload(schema, top_k=8, budget=16)
    h.update(repr(tracker.query_signatures(inferred, 64)).encode())

    # 3. replica signature features over the merged top signatures
    replica = importlib.import_module(f"{pkg}.service.replica")
    for sig, weight in tops:
        feats = replica.signature_features(sig, schema)
        h.update(np.ascontiguousarray(feats).tobytes())
        h.update(repr(float(weight)).encode())

    # 4. k-way ShardState merge (synthetic but exactly typed aggregates)
    sharded = importlib.import_module(f"{pkg}.engine.sharded")

    def shard(i: int):
        rng = np.random.default_rng(1000 + i)
        n_leaves, d, b, a = 8, 2, 4, 1
        return sharded.ShardState(
            shard_ids=(i,),
            n_leaves=n_leaves,
            counts=rng.integers(0, 100, n_leaves).astype(np.int64),
            lo=rng.integers(-50, 0, (n_leaves, d)).astype(np.int64),
            hi=rng.integers(1, 50, (n_leaves, d)).astype(np.int64),
            cat=rng.integers(0, 2, (n_leaves, b)).astype(bool),
            adv=rng.integers(0, 2, (n_leaves, a, 2)).astype(bool),
            n_batches=2,
            n_records=int(rng.integers(10, 50)),
            chunks={
                int(bid): [(i, rng.integers(0, 9, (3, d)).astype(np.int32))]
                for bid in range(i % 3 + 1)
            },
            wall_s=0.0,
        )

    folded = shard(0)
    for i in (1, 2, 3):
        folded = folded.merge(shard(i))
    h.update(repr(folded.shard_ids).encode())
    for arr in (folded.counts, folded.lo, folded.hi, folded.cat,
                folded.adv):
        h.update(np.ascontiguousarray(arr).tobytes())
    h.update(repr((folded.n_batches, folded.n_records)).encode())
    for bid in sorted(folded.chunks):
        for sid, rows in folded.chunks[bid]:
            h.update(repr((bid, sid)).encode())
            h.update(np.ascontiguousarray(rows).tobytes())
    return h.hexdigest()


if __name__ == "__main__":
    print(digest(sys.argv[1] if len(sys.argv) > 1 else "repro_torch"))
