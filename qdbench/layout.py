"""A configuration's layout file: load it, check its digest.

The file holds ``FrozenQdTree.to_arrays()``'s keys, as
``layouts/make_layouts.py`` wrote them.  Both sides get the same arrays:
the program through ``FrozenQdTree.from_arrays`` (which copies them), the
reference as they are.  numpy only: the reference reads this module too.
"""

from __future__ import annotations

import hashlib
import json
import pathlib

import numpy as np

BENCH = pathlib.Path(__file__).resolve().parent


def digest(arrays: dict) -> str:
    """sha256 over every array's name, dtype, shape and bytes, by name."""
    h = hashlib.sha256()
    for key in sorted(arrays):
        a = np.ascontiguousarray(arrays[key])
        h.update(f"{key}|{a.dtype.str}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def load_config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def load(config: dict) -> dict:
    """The configuration's layout arrays; raises if the digest differs from
    the one its file records."""
    path = BENCH / config["layout"]["file"]
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: np.array(z[k]) for k in z.files}
    want = config["layout_record"]["sha256"]
    got = digest(arrays)
    if got != want:
        raise ValueError(f"{path}: digest {got} is not the recorded {want}")
    return arrays


def schema(arrays: dict) -> list[tuple[str, str, int]]:
    """``(name, kind, domain)`` of each column of the layout's schema."""
    return [(n, k, int(d)) for n, k, d in json.loads(str(arrays["schema"]))]


def leaf_depths(arrays: dict) -> np.ndarray:
    """(n_leaves,) cuts on each leaf's root path (nodes in BFS order)."""
    cut_id, left, right = arrays["cut_id"], arrays["left"], arrays["right"]
    depth = np.zeros(cut_id.shape[0], np.int64)
    for node in range(cut_id.shape[0]):  # parents come before children
        if cut_id[node] >= 0:
            depth[left[node]] = depth[right[node]] = depth[node] + 1
    leaf = arrays["leaf_bid"] >= 0
    out = np.zeros(arrays["leaf_lo"].shape[0], np.int64)
    out[arrays["leaf_bid"][leaf]] = depth[leaf]
    return out
