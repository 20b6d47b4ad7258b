"""Device meshes, the reference's axis names over ``torch.distributed``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dims are
named as the reference's: ``("data", "model")`` or ``("pod", "data",
"model")``.  It spans the default process group, which
``init_process_group`` joins or creates: ``nccl`` for a CUDA device,
``gloo`` for ``device="cpu"``.  Importing this module touches no device
and no process group; a mesh whose size is not the world size raises.
"""

from __future__ import annotations

import datetime
import math
import os
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.engine.plan import resolve_device


def init_process_group(device=None, *, init_method: str | None = None,
                       rank: int | None = None,
                       world_size: int | None = None,
                       timeout_s: float = 300.0) -> torch.device:
    """Join the default process group, creating it if there is none, and
    return this rank's device (None: the GPU, raising without one).

    ``init_method`` is given explicitly (``file://...`` or
    ``tcp://host:port``, with ``rank`` and ``world_size``); without one,
    the ``torchrun`` environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``) is used when it is set, else a one-rank group over a
    ``file://`` store in a fresh temp dir.  On a CUDA device each rank
    takes card ``LOCAL_RANK`` (or its rank).
    """
    dev = resolve_device(device)
    if init_method is None:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            init_method = "env://"
            rank = int(os.environ["RANK"])
            world_size = int(os.environ["WORLD_SIZE"])
        else:
            store = os.path.join(tempfile.mkdtemp(prefix="qd_pg_"), "store")
            init_method, rank, world_size = f"file://{store}", 0, 1
    if rank is None or world_size is None:
        raise ValueError("an explicit init_method needs rank and world_size")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=init_method, rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s),
            device_id=dev if dev.type == "cuda" else None,
        )
    return dev


def _mesh(shape: tuple, axes: tuple, device=None) -> DeviceMesh:
    if not dist.is_initialized():
        if math.prod(shape) != 1:
            raise RuntimeError(
                f"a {shape} mesh needs a process group of "
                f"{math.prod(shape)} ranks: run under torchrun, or call "
                "init_process_group first")
        init_process_group(device)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} has {math.prod(shape)} devices; "
            f"the process group has {world}")
    # the device asked for; else the backend's (a fake group, as the
    # dry-run's, has neither)
    if device is not None:
        kind = torch.device(device).type
    else:
        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """16×16 single pod (256 devices) or 2×16×16 multi-pod (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_smoke_mesh(data: int = 1, model: int = 1, pod: int | None = None,
                    device=None) -> DeviceMesh:
    """A small mesh (one device by default) over the process group, which
    is created as a one-rank group on ``device`` when there is none."""
    if pod:
        return _mesh((pod, data, model), ("pod", "data", "model"), device)
    return _mesh((data, model), ("data", "model"), device)

