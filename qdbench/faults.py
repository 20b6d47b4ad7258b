"""Faults planted under the timed path, to show that ``correct`` fails.

``python3 qdbench/run.py ... --fault <name>`` plants one for the whole run;
the benchmark's own runs never do.  Each replaces a method of the torch
backend's running fold (``engine.backends.DeviceAccumulator``), on the
card and on the CPU alike:

* ``control``: the reference (``qdbench/reference``) in the program's
  place, breaking one guarantee the configuration states: the counts are
  exact, but each leaf's description comes from every SAMPLE_EVERY-th row
  only (sampled zone maps, the step that would tempt a faster fold);
* ``unchanged``: a fold that returns its state unchanged (nothing folded,
  every block id 0);
* ``half``: half of each batch left out (the rest folded, block id 0 for
  the rows left out);
* ``altered``: an answer altered where it is produced (one row's block id
  moved to the next block, one leaf's minimum lowered by one).

No cell runs across chips, so no exchange between chips can be left out.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from qdbench import reference

FAULTS = ("control", "unchanged", "half", "altered")
SAMPLE_EVERY = 64


def _ids(bids: torch.Tensor, return_bids: bool, on_device: bool):
    if not return_bids:
        return None
    return bids.to(torch.int32) if on_device else bids.to(
        torch.int32).cpu().numpy()


class ControlAccumulator:
    """The reference as the program's running fold, with sampled
    descriptions."""

    def __init__(self, tree, layout: reference.Layout):
        self.tree = tree
        self.layout = layout
        self.counts = reference.Fold.empty(layout)
        self.sampled = reference.Fold.empty(layout)

    def fold(self, records, return_bids=False, on_device=False):
        rows = torch.as_tensor(records).to(self.layout.device)
        bids = self.layout.route(rows)
        self.counts.counts += torch.bincount(bids,
                                             minlength=self.layout.n_leaves)
        self.sampled.add(self.layout, rows[::SAMPLE_EVERY],
                         bids[::SAMPLE_EVERY])
        return _ids(bids, return_bids, on_device)

    def partial(self):
        from repro_torch.core.qdtree import TightenPartial

        s = self.sampled
        return TightenPartial(
            counts=self.counts.counts.cpu().numpy(), lo=s.lo.cpu().numpy(),
            hi=s.hi.cpu().numpy(), cat=s.cat.cpu().numpy(),
            adv=s.adv.cpu().numpy())


@contextlib.contextmanager
def planted(name: str, arrays: dict, device):
    """Plant fault ``name`` (None: none) for the ``with`` body."""
    if name is None:
        yield
        return
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    from repro_torch.engine import backends as be

    cls, backend = be.DeviceAccumulator, be.TorchBackend
    saved = {"fold": cls.fold, "partial": cls.partial,
             "accumulator": backend.accumulator}
    fold, partial = saved["fold"], saved["partial"]

    def unchanged(self, records, return_bids=False, on_device=False):
        zeros = torch.zeros(records.shape[0], dtype=torch.int32,
                            device=self.device)
        return _ids(zeros, return_bids, on_device)

    def half(self, records, return_bids=False, on_device=False):
        m = records.shape[0]
        got = fold(self, records[: m // 2], return_bids, on_device=True)
        if got is None:
            return None
        rest = torch.zeros(m - m // 2, dtype=torch.int32, device=got.device)
        return _ids(torch.cat([got, rest]), True, on_device)

    def altered_fold(self, records, return_bids=False, on_device=False):
        got = fold(self, records, return_bids, on_device=True)
        if got is None:
            return None
        got[0] = (got[0] + 1) % self.tree.n_leaves
        return _ids(got, True, on_device)

    def altered_partial(self):
        p = partial(self)
        leaf = int(np.argmax(p.counts > 0))
        p.lo[leaf, 0] -= 1
        return p

    def control(self, tree, cache, device, launch=None):
        return ControlAccumulator(tree, reference.Layout(arrays, device))

    try:
        if name == "control":
            backend.accumulator = control
        elif name == "unchanged":
            cls.fold = unchanged
        elif name == "half":
            cls.fold = half
        else:
            cls.fold, cls.partial = altered_fold, altered_partial
        yield
    finally:
        cls.fold, cls.partial = saved["fold"], saved["partial"]
        backend.accumulator = saved["accumulator"]
