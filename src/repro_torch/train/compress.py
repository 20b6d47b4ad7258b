"""Int8 error-feedback gradient compression for the cross-pod all-reduce,
as the reference's.

Gradients are reduced *within* a pod as the sharded step does (over
``data`` and ``model``); over ``pod`` each pod quantizes (grad +
error-feedback residual) to int8 with one f32 absmax scale per row (the
last axis), all-gathers the int8 payload and the scales over the pod
sub-group (4× fewer wire bytes than f32), dequantizes and averages
locally, and keeps the quantization error as next step's residual, which
stays local to the pod.  Scalars are averaged in f32.

A leaf may be a DTensor on the pod's (data, model) mesh: the row absmax is
then taken over the whole row, its shards on other ranks included, and
each rank gathers its own shard's payload from the other pods.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.model import leaves, tree_map


def _quant(x: torch.Tensor):
    """Per-row (last-axis) absmax int8 codes and their f32 scales."""
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-20) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    """(n, *t.shape): ``t`` from every rank of ``group``, in rank order."""
    n = dist.get_world_size(group)
    out = torch.empty(n * t.numel(), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.reshape(-1), group=group)
    return out.reshape((n,) + tuple(t.shape))


def _sync_leaf(g, err, n_pods: int, group):
    """One leaf: → (synced grad, new error residual)."""
    g32 = g.to(torch.float32)
    if g.dim() == 0:  # scalars: a plain mean, no quantization
        out = g32.to_local() if isinstance(g32, DTensor) else g32
        out = out.clone()
        dist.all_reduce(out, group=group)
        out = out / n_pods
        if isinstance(g32, DTensor):
            out = DTensor.from_local(out, g32.device_mesh, g32.placements,
                                     run_check=False)
        return out.to(g.dtype), err
    total = g32 + err
    q, scale = _quant(total)
    new_err = total - q.to(torch.float32) * scale
    if isinstance(q, DTensor):  # each rank gathers its own shard
        last = Shard(q.dim() - 1)  # a scale is its row's, whole
        scale = scale.redistribute(q.device_mesh, tuple(
            Replicate() if p == last else p for p in q.placements))
        ql, sl = q.to_local(), scale.to_local()
    else:
        ql, sl = q, scale
    qs = _gather(ql, group)  # int8 on the wire
    ss = _gather(sl, group)
    out = (torch.sum(qs.to(torch.float32) * ss, dim=0) / n_pods).to(g.dtype)
    if isinstance(q, DTensor):
        out = DTensor.from_local(out, q.device_mesh, q.placements,
                                 run_check=False, shape=q.shape,
                                 stride=q.stride())
    return out, new_err


def make_pod_sync(mesh):
    """→ (sync(grads, err) -> (grads, err), the mesh's other axes, the
    number of pods).  ``grads`` are the pod's own (computed on its batch
    alone)."""
    n_pods = dict(zip(mesh.mesh_dim_names, mesh.shape))["pod"]
    group = mesh.get_group("pod")
    auto = frozenset(a for a in mesh.mesh_dim_names if a != "pod")

    def sync(grads, err):
        g_leaves = list(leaves(grads))
        e_leaves = list(leaves(err))
        pairs = [_sync_leaf(g, e, n_pods, group)
                 for g, e in zip(g_leaves, e_leaves)]
        it_g = iter(p[0] for p in pairs)
        it_e = iter(p[1] for p in pairs)
        return (tree_map(lambda _: next(it_g), grads),
                tree_map(lambda _: next(it_e), err))

    return sync, auto, n_pods


def init_error_state(params):
    """Error-feedback residuals: f32 zeros shaped (and placed) as each
    param."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def compressed_wire_bytes(params) -> int:
    """Wire bytes per pod-sync with int8 payloads."""
    total = 0
    for p in leaves(params):
        if p.dim() == 0:
            total += 4
        else:
            rows = int(p.numel() // p.shape[-1])
            total += int(p.numel()) + 4 * rows  # int8 + f32 row scales
    return total
