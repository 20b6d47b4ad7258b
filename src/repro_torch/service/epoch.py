"""Epoch: the one serving-provenance type for the layout lifecycle.

Before replica sets, the serving tier passed bare ``(generation,
desc_version)`` tuples between ``LayoutService.live_epoch``, the result
cache, and the dispatch loop.  Replicated layouts add a third coordinate
— *which replica* a result was computed against — and an untyped
3-tuple convention in four modules is exactly how provenance bugs are
born.  :class:`Epoch` is the shared frozen dataclass all of them speak:

* ``generation`` — the service-wide monotonic deploy counter
  (:meth:`LayoutService.swap` and friends); unique across replicas.
* ``desc_version`` — the tree's leaf-description version: in-place
  tightening during ingest bumps it without a swap, changing
  ``query_hits`` results for the same generation.
* ``replica_id`` — position of the tree in the live
  :class:`~repro_torch.service.replica.ReplicaSet` (0 for the primary, and
  for every pre-replica call site via the default).

Ordered and hashable so epochs can key caches and sort into audit
trails; iterable so legacy ``list(epoch)`` / tuple-unpacking call sites
keep working during the migration.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator


@dataclasses.dataclass(frozen=True, order=True)
class Epoch:
    """One serving epoch: ``(generation, desc_version, replica_id)``.

    Any movement of the first two coordinates retires every result
    computed under the old epoch — this is the result-cache invalidation
    key (`repro_torch.serve.cache`).  The third coordinate scopes that
    invalidation: hot-swapping one replica retires only that replica's
    entries.
    """

    generation: int
    desc_version: int
    replica_id: int = 0

    def __iter__(self) -> Iterator[int]:
        yield self.generation
        yield self.desc_version
        yield self.replica_id


__all__ = ["Epoch"]
