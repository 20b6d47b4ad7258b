"""Logical-axis sharding rules (MaxText-style), as the reference's.

Models annotate every weight and key activation with *logical* axis
names; ``Rules`` maps logical names to mesh axes; resolution drops mesh
axes that don't exist, so the same model code runs on the single-pod
``(data, model)`` mesh, the multi-pod ``(pod, data, model)`` one and a
one-device mesh.  A resolved spec is the port's own ``PartitionSpec``, a
tuple with one entry a tensor dim (``None``, an axis name, or a tuple of
names), equal to the reference's for the same rules and mesh;
``placements`` turns it into DTensor placements, one a mesh dim.

``logical_constraint`` is the identity without an active mesh, and on a
plain tensor; on a DTensor it redistributes to the placements of the
spec fitted to its shape (``fitted_spec``).

Default placement (the reference's):
  * weights: FSDP along ``fsdp``→data, tensor-parallel along heads/mlp/
    vocab/experts→model; ``pod`` is pure data parallel.
  * activations: batch over (pod, data); residual-stream seq over model
    (sequence parallelism); attention/MLP interiors head-/ff-sharded.
  * KV caches: batch over data, kv-heads over model; the 512k decode
    cells override to sequence-sharded caches.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

DEFAULT_RULES: dict[str, tuple[str, ...] | None] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_sp": ("model",),  # sequence-parallel residual stream
    "embed": None,
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "mlp": ("model",),
    "vocab": ("model",),
    "fsdp": ("data",),
    "experts": ("model",),
    "expert_cap": ("data",),
    "ssm_heads": ("model",),
    "state": None,
    "cache_seq": None,
    "frames": None,
    "layers": None,
    "conv": None,
    "patches": None,
    None: None,
}

# per-shape overrides (keyed by input-shape name)
LONG_CONTEXT_OVERRIDES = {
    "batch": None,  # batch=1: don't shard
    # shard the 512k KV/conv cache over sequence, as many ways as divide
    "cache_seq": ("pod", "data", "model"),
    "seq_sp": ("model",),
}


class PartitionSpec(tuple):
    """One entry a tensor dim: ``None``, a mesh axis, or a tuple of them
    (major first).  A tuple, so it equals the reference's spec."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


P = PartitionSpec


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, or of any object with
    ``axis_names`` and a ``shape`` dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


@dataclasses.dataclass(frozen=True)
class Rules:
    table: tuple[tuple[str | None, tuple[str, ...] | None], ...]

    @staticmethod
    def make(overrides: dict | None = None) -> "Rules":
        t = dict(DEFAULT_RULES)
        if overrides:
            t.update(overrides)
        return Rules(table=tuple(t.items()))

    def lookup(self, name: str | None) -> tuple[str, ...] | None:
        for k, v in self.table:
            if k == name:
                return v
        raise KeyError(f"unknown logical axis {name!r}")

    def without_axis(self, axis: str) -> "Rules":
        """Strip a mesh axis from every rule (for a manual region, where
        constraints must not mention the manual axis)."""
        table = []
        for k, v in self.table:
            if v is not None:
                v = tuple(a for a in v if a != axis) or None
            table.append((k, v))
        return Rules(table=tuple(table))

    def with_rule(self, name: str | None,
                  axes: tuple[str, ...] | None) -> "Rules":
        """These rules with ``name`` mapped to ``axes``."""
        return Rules(table=tuple((k, axes if k == name else v)
                                 for k, v in self.table))

    def spec(self, logical_axes: tuple, mesh) -> P:
        """Resolve logical axes to a PartitionSpec on ``mesh``."""
        names = axis_sizes(mesh)
        parts = []
        used: set[str] = set()
        for name in logical_axes:
            axes = self.lookup(name)
            if axes is None:
                parts.append(None)
                continue
            present = tuple(a for a in axes if a in names and a not in used)
            used.update(present)
            parts.append(axes_part(present))
        return P(*parts)


def axes_part(kept) -> str | tuple | None:
    """A spec's entry for a tensor dim split over the mesh axes ``kept``
    (major first)."""
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else tuple(kept)


# ---------------------------------------------------------------------------
# mesh context: models call logical_constraint without threading a mesh
# ---------------------------------------------------------------------------
class _Ctx(threading.local):
    mesh = None
    rules: Optional[Rules] = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh, rules: Rules):
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def recompute_context():
    """``torch.utils.checkpoint``'s ``context_fn``: a checkpointed
    region's recomputation, which the autograd engine runs on a thread of
    its own for CUDA tensors, runs under the mesh and rules of its
    forward (``use_mesh`` is thread-local)."""
    return contextlib.nullcontext(), use_mesh(_CTX.mesh, _CTX.rules)


def active_mesh():
    return _CTX.mesh


def active_rules() -> Optional[Rules]:
    return _CTX.rules


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim named at tensor dim ``d``, ``Replicate()`` on the rest.  A
    tensor dim over several mesh dims is split major first, as the
    reference's.  A mesh dim of size 1 replicates: a shard over it is the
    whole tensor."""
    out = []
    for name, size in zip(mesh.mesh_dim_names, mesh.shape):
        dims = [d for d, part in enumerate(spec)
                if part == name or (isinstance(part, tuple) and name in part)]
        out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
    return tuple(out)


def logical_constraint(x, logical_axes: tuple):
    """Redistribute a DTensor to its logical axes' fitted layout
    (``fitted_spec``: a mesh axis that does not divide a dim leaves it
    whole, where the reference's partitioner pads); the identity without
    an active mesh and on a plain tensor."""
    if _CTX.mesh is None or _CTX.rules is None or not isinstance(x, DTensor):
        return x
    return _redistribute(x, fitted_spec(tuple(x.shape), logical_axes,
                                        _CTX.mesh, _CTX.rules))


def _redistribute(x: DTensor, spec: P) -> DTensor:
    want = placements(spec, _CTX.mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(_CTX.mesh, want)


class _GradLayout(torch.autograd.Function):
    """Identity whose backward lays the gradient out as ``want``."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.want:
            g = g.redistribute(g.device_mesh, ctx.want)
        return g, None


def merge_dims(x, dim: int, logical_axes: tuple):
    """``x`` with dims ``dim`` and ``dim + 1`` merged.  Under a mesh a
    DTensor and its gradient are laid out as the fitted spec of
    ``logical_axes`` on ``x`` (dim ``dim + 1`` whole), so that the
    backward's view back to ``x``'s shape never unflattens an uneven
    split."""
    shape = tuple(x.shape)
    merged = shape[:dim] + (shape[dim] * shape[dim + 1],) + shape[dim + 2:]
    if _CTX.mesh is None or _CTX.rules is None or not isinstance(x, DTensor):
        return x.reshape(merged)
    spec = fitted_spec(shape, logical_axes, _CTX.mesh, _CTX.rules)
    if spec[dim + 1] is not None:
        raise ValueError(f"dim {dim + 1} may not be split: {spec}")
    flat = _redistribute(x, spec).reshape(merged)
    return _GradLayout.apply(
        flat, placements(P(*(spec[:dim + 1] + spec[dim + 2:])), _CTX.mesh))


def unflatten_last(x, tail: tuple, logical_axes: tuple):
    """``x`` with its last dim viewed as ``tail``.  Under a mesh a DTensor
    is first laid out as the fitted spec of ``logical_axes`` on the viewed
    shape, the merged dim split as ``tail``'s first dim: a view cannot
    unflatten a dim split over a mesh axis that does not divide that
    first dim (24 heads of a flat projection on a 16-way ``model``)."""
    shape = tuple(x.shape[:-1]) + tuple(tail)
    if _CTX.mesh is not None and _CTX.rules is not None \
            and isinstance(x, DTensor):
        spec = fitted_spec(shape, logical_axes, _CTX.mesh, _CTX.rules)
        if any(part is not None for part in spec[x.dim():]):
            raise ValueError(f"only the first of {tail} may be split: {spec}")
        x = _redistribute(x, P(*spec[:x.dim()]))
    return x.reshape(shape)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec on it: where a tensor's shards lie."""

    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def named_sharding(logical_axes: tuple, mesh=None, rules=None):
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None or rules is None:
        raise RuntimeError("no active mesh context")
    return NamedSharding(mesh, rules.spec(logical_axes, mesh))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x
    )


def tree_map_specs(fn, tree, spec_tree):
    """``fn(leaf, axes)`` over a tree of dicts and lists (a layer stack)
    with its logical-axes tree alongside."""
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v, spec_tree[k])
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_specs(fn, v, s) for v, s in zip(tree, spec_tree)]
    return fn(tree, spec_tree)


def tree_shardings(spec_tree, mesh, rules: Rules):
    """Map a tree of logical-axes tuples to NamedShardings."""
    if _is_axes(spec_tree):
        return NamedSharding(mesh, rules.spec(spec_tree, mesh))
    if isinstance(spec_tree, dict):
        return {k: tree_shardings(v, mesh, rules)
                for k, v in spec_tree.items()}
    return [tree_shardings(v, mesh, rules) for v in spec_tree]


def fitted_spec(shape: tuple, logical_axes: tuple, mesh,
                rules: Rules) -> P:
    """Resolve logical axes, pruning mesh axes that don't divide the dim.

    Per dim we keep the longest prefix of the rule's mesh axes whose size
    product divides the dimension: a 2-head KV projection on a 16-way
    ``model`` axis falls back to replication, and a 512k cache_seq rule
    ("pod","data","model") uses as many axes as divide.
    """
    if len(shape) != len(logical_axes):
        raise ValueError(
            f"rank mismatch: shape {shape} vs axes {logical_axes}"
        )
    sizes = axis_sizes(mesh)
    parts = []
    used: set[str] = set()
    for dim, name in zip(shape, logical_axes):
        axes = rules.lookup(name)
        kept: list[str] = []
        if axes:
            size = 1
            for a in axes:
                if a not in sizes or a in used:
                    continue
                nxt = size * sizes[a]
                if dim % nxt == 0:
                    kept.append(a)
                    size = nxt
                else:
                    break
        used.update(kept)
        parts.append(axes_part(kept))
    return P(*parts)


def fitted_shardings(shape_tree, spec_tree, mesh, rules: Rules):
    """NamedShardings for a state's leaves: shape-aware,
    divisibility-safe.  ``shape_tree`` holds tensors (``meta`` ones
    too)."""
    return tree_map_specs(
        lambda t, axes: NamedSharding(
            mesh, fitted_spec(tuple(t.shape), axes, mesh, rules)),
        shape_tree, spec_tree)


# ---------------------------------------------------------------------------
# placing and gathering trees of tensors
# ---------------------------------------------------------------------------
def distribute(tree, shardings):
    """Each full tensor of ``tree`` as a DTensor placed by its
    NamedSharding.  Every rank holds the same full values (drawn from one
    seeded generator, or read from one checkpoint) and keeps its own
    shard: no data moves.  A 0-d tensor (a step counter) stays plain."""
    return tree_map_specs(
        lambda t, sh: t if t.dim() == 0 else distribute_tensor(
            t, sh.mesh, sh.placements, src_data_rank=None),
        tree, shardings)


def place(tree, shardings, dtensor: bool | None = None):
    """``tree``'s full tensors placed by ``shardings``: DTensors, or the
    tensors as they are on a mesh of one device (where every placement is
    the whole tensor) unless ``dtensor`` asks for DTensors there too."""
    first = shardings
    while not isinstance(first, NamedSharding):
        first = next(iter(first.values())) if isinstance(first, dict) \
            else first[0]
    if dtensor is None:
        dtensor = first.mesh.size() > 1
    return distribute(tree, shardings) if dtensor else tree


def assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst[...] = src``, in place, ``src`` laid out as ``dst`` first; on
    DTensors each rank copies its own shard (an in-place op on DTensors
    fails in some torch releases)."""
    if isinstance(dst, DTensor):
        src = as_dtensor(src, dst.device_mesh).redistribute(
            dst.device_mesh, dst.placements)
    local(dst).copy_(local(src))


def full(x: torch.Tensor) -> torch.Tensor:
    """The whole value of a DTensor (gathered over the mesh); a plain
    tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def local(x: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor; a plain tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def replicate(x: torch.Tensor) -> torch.Tensor:
    """A DTensor redistributed to ``Replicate`` on every mesh dim (before
    an op that has no DTensor sharding rule for its layout); a plain
    tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    want = (Replicate(),) * x.device_mesh.ndim
    return x if tuple(x.placements) == want else x.redistribute(
        x.device_mesh, want)


def batch_only(x: torch.Tensor) -> torch.Tensor:
    """A DTensor kept split along dim 0 only: every other shard gathered
    and every partial sum reduced (before an op with no DTensor rule for
    those layouts); a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    want = tuple(p if p == Shard(0) else Replicate() for p in x.placements)
    return x if tuple(x.placements) == want else x.redistribute(
        x.device_mesh, want)


def as_dtensor(x: torch.Tensor, mesh) -> DTensor:
    """A DTensor on ``mesh`` (None: ``x`` as it is); a plain tensor is
    taken as replicated (the same full value on every rank)."""
    if mesh is None or isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: a local
    gradient in another layout (an einsum's backward gives permuted ones)
    would come back as a DTensor whose view ops fail."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def take_local(t: torch.Tensor, spec: P, mesh,
               partial_grad=False) -> torch.Tensor:
    """This rank's shard of ``t`` (a DTensor, or a plain tensor holding
    the full value on every rank) laid out as ``spec``.  With
    ``partial_grad`` its gradient is partial over the mesh dims it is
    replicated on (each replica passes back its own share, to be summed),
    or over those of them named in ``partial_grad`` when it is a
    collection of axis names; else each replica's gradient is taken to be
    the whole one."""
    want = placements(spec, mesh)
    grad = None
    if partial_grad:
        every = partial_grad is True
        grad = tuple(
            Partial() if isinstance(p, Replicate) and (
                every or name in partial_grad) else p
            for name, p in zip(mesh.mesh_dim_names, want))
    shard = as_dtensor(t, mesh).redistribute(mesh, want).to_local(
        grad_placements=grad)
    return _ContiguousGrad.apply(shard)


def shard_local(fn, args: tuple, axes: tuple, out_axes):
    """``fn`` on this rank's shards of ``args``: the counterpart of a
    ``shard_map`` region with no collectives, for a computation that is
    parallel over the dims sharded here (attention over batch and KV
    heads).  Under an active mesh, with a DTensor among ``args``, each arg
    is redistributed to the fitted layout of its logical axes and taken
    local; the result (or each of a tuple of results, ``out_axes`` then
    one tuple of axes each) is a DTensor laid out over the same mesh axes
    for the same logical names.  Otherwise ``fn(*args)``.

    Backward needs no collective of its own: on a mesh axis that splits
    no arg every replica computes alike and gets the whole gradient; an
    arg replicated over an axis that splits another (a weight beside a
    batch split) gets a gradient partial over it, summed by DTensor."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None or rules is None or not any(
            isinstance(a, DTensor) for a in args):
        return fn(*args)
    # a logical name is split only as far as it divides every dim it
    # names (query heads beside fewer KV heads)
    common: dict = {}
    for a, ax in zip(args, axes):
        for n, name in zip(a.shape, ax):
            if name is not None:
                common[name] = math.gcd(common.get(name, 0), n)
    by_name: dict = {}
    fitted = []
    for a, ax in zip(args, axes):
        fit = tuple(common[name] if name is not None else n
                    for n, name in zip(a.shape, ax))
        spec = fitted_spec(fit, ax, mesh, rules)
        for name, part in zip(ax, spec):
            if name is not None and by_name.setdefault(name, part) != part:
                raise ValueError(f"logical axis {name!r} is laid out both "
                                 f"as {by_name[name]} and as {part}")
        fitted.append(spec)
    split = set().union(*(axes_of(spec) for spec in fitted))
    local_args = [take_local(a, spec, mesh, split - axes_of(spec))
                  for a, spec in zip(args, fitted)]
    out = fn(*local_args)
    if isinstance(out, tuple):
        return tuple(
            from_local(o, P(*(by_name.get(n) for n in ax)), mesh)
            for o, ax in zip(out, out_axes))
    return from_local(out, P(*(by_name.get(n) for n in out_axes)), mesh)


def axes_of(spec: P) -> set:
    """The mesh axes a spec splits over."""
    return {a for part in spec
            for a in (part if isinstance(part, tuple) else (part,))
            if a is not None}


def axes_index(mesh, axes) -> int:
    """This rank's index along the mesh axes ``axes`` taken as one (the
    mesh's order, major first, as DTensor nests a dim split over them)."""
    sizes = axis_sizes(mesh)
    index = 0
    for name, c in zip(mesh.mesh_dim_names, mesh.get_coordinate()):
        if name in axes:
            index = index * sizes[name] + c
    return index


def from_local(t: torch.Tensor, spec: P, mesh) -> DTensor:
    """A DTensor whose shard on this rank is ``t``, laid out as ``spec``
    (every shard the same shape)."""
    sizes = axis_sizes(mesh)
    shape = list(t.shape)
    for d, part in enumerate(spec):
        for a in (part if isinstance(part, tuple) else (part,)):
            if a is not None:
                shape[d] *= sizes[a]
    return DTensor.from_local(t.contiguous(), mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def shard_start(x: DTensor, dim: int) -> tuple[int, int]:
    """(first index, length) along ``dim`` of this rank's shard of the
    DTensor ``x``: each mesh dim that shards ``dim`` cuts this rank's part
    into equal parts, in the mesh's order, as DTensor nests them."""
    mesh = x.device_mesh
    start, length = 0, x.shape[dim]
    for p, size, c in zip(x.placements, mesh.shape, mesh.get_coordinate()):
        if p.is_shard(dim):
            length //= size
            start += c * length
    return start, length


def spec_of(x: DTensor) -> P:
    """The spec a DTensor is laid out as: each dim's sharding mesh axes,
    in the mesh's order."""
    parts: list[list] = [[] for _ in range(x.dim())]
    for name, p in zip(x.device_mesh.mesh_dim_names, x.placements):
        if p.is_shard():
            parts[p.dim].append(name)
    return P(*(axes_part(tuple(q)) for q in parts))
