"""Checkpoints in the reference's format, with atomic and async saves.

Format (``repro.train.checkpoint``'s): one ``.npy`` per leaf of the state,
named by its tree path (``params__layers__slot0__mix__wq``), with the layer
groups stacked on a leading axis as the reference keeps them, plus a
``manifest.json`` listing the leaves in the reference's (sorted) order.
So a checkpoint written by either package restores in the other: the port
stacks its per-group lists on save (``model.state_to_jax``) and slices them
again on restore.  bfloat16 leaves are written as the reference's
``np.save`` writes them, raw 2-byte words under ``'<V2'``.

A sharded state (DTensor leaves) is saved whole: each leaf is gathered
over its mesh and one rank (rank 0) writes, as the reference writes
logical (unsharded) arrays.  ``restore_checkpoint`` reads the whole
leaves and, given placements, lays them out on the current mesh, so a
checkpoint taken on one mesh restores onto another or onto one device
(elastic resharding).

Safety: writes go to ``step_<n>.tmp`` and are renamed only when complete,
so a crash mid-save never corrupts the latest checkpoint; ``keep`` bounds
disk use; ``async_save`` moves the writing off the training thread (the
copy to the host stays on it, so the writer never reads live device
tensors).
"""

from __future__ import annotations

import json
import pathlib
import re
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.engine.plan import resolve_device
from repro_torch.models import model
from repro_torch.sharding import specs as sh


def _flatten(tree, prefix: str = ""):
    """(key, leaf) of a tree of dicts in the reference's order: keys
    sorted, joined by ``__`` (``root`` for a bare leaf)."""
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            yield from _flatten(v, f"{prefix}__{k}" if prefix else k)
    else:
        yield prefix or "root", tree


def _save_npy(path: pathlib.Path, arr: np.ndarray) -> None:
    if arr.dtype.kind == "V":  # bfloat16's raw words, as the reference's
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(f, {
                "descr": "<V2", "fortran_order": False,
                "shape": arr.shape})
            f.write(np.ascontiguousarray(arr).tobytes())
    else:
        np.save(path, arr)


def save_checkpoint(ckpt_dir, step: int, state, keep: int = 3,
                    async_save: bool = False):
    """Atomically persist ``state`` at ``step``.  Returns the final path
    (or a join()-able thread when ``async_save``).  Under a process group
    every rank calls it (the gather is collective) and rank 0 writes; a
    synchronous save returns on every rank once the files are in place."""
    root = pathlib.Path(ckpt_dir)
    host = list(_flatten(model.state_to_jax(model.tree_map(sh.full, state))))
    distributed = dist.is_initialized() and dist.get_world_size() > 1
    if distributed and dist.get_rank() != 0:
        if async_save:
            t = threading.Thread(target=lambda: None, daemon=True)
            t.start()
            return t
        dist.barrier()
        return root / f"step_{step}"
    root.mkdir(parents=True, exist_ok=True)

    def _write():
        tmp = root / f"step_{step}.tmp"
        final = root / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        for key, arr in host:
            _save_npy(tmp / f"{key}.npy", arr)
        (tmp / "manifest.json").write_text(
            json.dumps({"step": step, "leaves": [k for k, _ in host]})
        )
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        _gc(root, keep)
        return final

    if async_save:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    final = _write()
    if distributed:
        dist.barrier()
    return final


def _gc(root: pathlib.Path, keep: int) -> None:
    for s in all_steps(root)[:-keep]:
        shutil.rmtree(root / f"step_{s}", ignore_errors=True)


def all_steps(ckpt_dir) -> list[int]:
    root = pathlib.Path(ckpt_dir)
    out = []
    if not root.exists():
        return out
    for p in root.iterdir():
        m = re.fullmatch(r"step_(\d+)", p.name)
        if m and (p / "manifest.json").exists():
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir, step: int, like, device=None,
                       placements=None):
    """Restore into the structure, shapes and dtypes of ``like`` (a state,
    or ``steps.abstract_state``'s ``meta`` one), on ``device`` (None: the
    GPU, raising without one).  Each list of ``like`` (a layer stack) is
    read as one stacked file a leaf and sliced into its groups.  With
    ``placements`` (NamedShardings shaped as ``like``, e.g.
    ``steps.jit_train_step``'s) each rank reads the whole leaves and keeps
    its shards (``specs.place``)."""
    root = pathlib.Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((root / "manifest.json").read_text())
    if manifest["step"] != step:
        raise ValueError(f"{root}: manifest says step {manifest['step']}")
    dev = resolve_device(device)

    def load(key: str, ref: torch.Tensor, lead: tuple) -> torch.Tensor:
        arr = np.load(root / f"{key}.npy")
        want = lead + tuple(ref.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"checkpoint leaf {key}: shape {arr.shape} != "
                             f"expected {want}")
        return model.tensor_from_numpy(arr, dev).to(ref.dtype)

    def walk(t, key: str, lead: tuple = ()):
        if isinstance(t, dict):
            return {k: walk(v, f"{key}__{k}" if key else k, lead)
                    for k, v in t.items()}
        if isinstance(t, list):  # a layer stack: stacked on disk
            stacked = walk(t[0], key, lead + (len(t),))
            return [model.tree_map(lambda a, g=g: a[g], stacked)
                    for g in range(len(t))]
        return load(key or "root", t, lead)

    state = walk(like, "")
    return state if placements is None else sh.place(state, placements)
