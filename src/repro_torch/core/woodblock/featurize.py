"""State featurization for WOODBLOCK (paper Sec 5.2.3).

Each state (tree node) is the concatenation of its ``range`` and
``categorical_mask`` description; numeric bounds are binary-encoded ("these
vectors are encoded in bits"), categorical masks are already bits, and the
advanced-cut bit pairs are appended.  Output is a fixed-size float32 vector.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.predicates import Schema
from repro_torch.core.qdtree import NodeDesc


class Featurizer:
    def __init__(self, schema: Schema, n_adv: int):
        self.schema = schema
        self.n_adv = n_adv
        doms = schema.doms
        # bits needed to binary-encode a bound in [0, dom] (hi can equal dom)
        self.nbits = np.maximum(
            1, np.ceil(np.log2(doms.astype(np.float64) + 1)).astype(np.int64)
        )
        self.numeric = np.nonzero(~schema.is_categorical)[0]
        self.cat_bits = max(schema.total_cat_bits, 0)
        self.dim = int(
            2 * self.nbits[self.numeric].sum() + self.cat_bits + 2 * n_adv
        )
        # precompute bit-shift tables per numeric dim
        self._shifts = [np.arange(self.nbits[d]) for d in self.numeric]

    def __call__(self, desc: NodeDesc) -> np.ndarray:
        parts = []
        for i, d in enumerate(self.numeric):
            sh = self._shifts[i]
            parts.append((desc.lo[d] >> sh) & 1)
            parts.append((desc.hi[d] >> sh) & 1)
        if self.cat_bits:
            parts.append(desc.cat.astype(np.int64))
        if self.n_adv:
            parts.append(desc.adv.reshape(-1).astype(np.int64))
        return np.concatenate(parts).astype(np.float32)

    def batch(self, descs: list[NodeDesc]) -> np.ndarray:
        if not descs:
            return np.zeros((0, self.dim), np.float32)
        return np.stack([self(d) for d in descs])
