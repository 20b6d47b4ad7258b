"""Per-device cost of a step from its dispatched ops: the counterpart of
the reference's post-SPMD HLO analysis (``repro.launch.hlo``).

The port compiles no HLO.  ``StepRecorder``, a ``TorchDispatchMode``, runs
around one step on DTensors (fake ones in the dry-run) and sees each op
as one rank runs it: a DTensor op is let through to DTensor's dispatch
(the mode returns ``NotImplemented``, as ``CommDebugMode`` does), which
runs it on this rank's shards and calls the collectives its
redistributions need; those local ops and collectives come back to the
mode.  From them it records:

  * the collective inventory (``parse_collectives``' schema,
    ``{kind: {"count", "bytes"}}``): each all_reduce,
    all_gather_into_tensor, reduce_scatter_tensor, all_to_all_single and
    send/recv/permute, functional or in place, under ``COLLECTIVES``' five
    names, ``bytes`` its operands' local-shard bytes (the reference counts
    per-device operands too);
  * ``cost_dict``: ``flops``, from ``FlopCounterMode``'s own per-op
    formulas (``torch.utils.flop_counter.flop_registry``: matmuls,
    convolutions, attention; 2 per multiply-add) on the local shapes, and
    ``bytes accessed``, each op's input plus output bytes: XLA's unfused
    count, views excluded (XLA's bitcasts move nothing);
  * ``fused_bytes``: those bytes for the ops that ``_MEM_OPS`` names, the
    ones that still touch memory after fusion (``fused_bytes_estimate``);
  * live bytes: each op's new outputs from their allocation until their
    storage is freed, and the peak (the dry-run's ``temp_size``);
    ``largest_live``, the ``LARGEST_LIVE`` largest of the storages live at
    the peak (within ``LARGEST_LIVE_SLACK`` of it), each with the op that
    made it, its shape and dtype: what holds a cell's memory.

How it differs from XLA's figures: no fusion, so ``bytes accessed``
counts every elementwise intermediate; FLOPs count only the ops with a
formula (elementwise math, softmax and norms are left out, where XLA
counts them); a ``while`` body is not the question here (the port loops
over layer groups and records every pass); collectives are the ones
DTensor chose, not XLA's, and their algorithms' constants are left out.
"""

from __future__ import annotations

import heapq
import sys
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1,
    "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

LARGEST_LIVE = 12
LARGEST_LIVE_SLACK = 1.005  # a new peak this far over the last snapshot

COLLECTIVES = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# torch dtypes under XLA's names
XLA_DTYPES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.uint16: "u16", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int32: "s32", torch.uint32: "u32",
    torch.float32: "f32", torch.int64: "s64", torch.uint64: "u64",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
}


def tensor_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * DTYPE_BYTES.get(dtype, 4)


def torch_bytes(t: torch.Tensor) -> int:
    """``tensor_bytes`` of a torch tensor (its local shard, for a
    DTensor)."""
    if isinstance(t, DTensor):
        t = t.to_local()
    return tensor_bytes(XLA_DTYPES.get(t.dtype, "f32"),
                        ",".join(str(d) for d in t.shape))


def total_collective_bytes(coll: dict) -> int:
    return sum(v["bytes"] for v in coll.values())


# collective op names → (kind, index of the operand argument)
_COLL = (
    ("all_reduce", "all-reduce", 0), ("allreduce", "all-reduce", 0),
    ("_allgather_base", "all-gather", 1), ("allgather", "all-gather", 1),
    ("all_gather", "all-gather", 0),
    ("_reduce_scatter_base", "reduce-scatter", 1),
    ("reduce_scatter", "reduce-scatter", 0),
    ("alltoall_base", "all-to-all", 1), ("alltoall", "all-to-all", 1),
    ("all_to_all", "all-to-all", 0),
    ("permute", "collective-permute", 0), ("send", "collective-permute", 0),
    ("recv", "collective-permute", 0),
)

# the ops that still touch memory after fusion: XLA's dot, convolution,
# scatter, gather, dynamic-(update-)slice, copy, transpose, sort, and the
# collectives
_MEM_OPS = frozenset({
    "mm", "bmm", "addmm", "baddbmm", "matmul", "convolution",
    "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_flash_attention",
    "scatter", "scatter_add", "scatter_reduce", "index_put", "index_put_",
    "_index_put_impl_", "index_add", "index_add_", "gather", "index",
    "index_select", "embedding", "embedding_dense_backward",
    "slice_scatter", "select_scatter", "copy_", "clone", "_to_copy",
    "cat", "stack", "sort", "topk", "argsort",
})


def _collective(func):
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d_functional", "c10d",
                  "_c10d_functional_autograd"):
        return None
    name = func._overloadpacket.__name__
    for key, kind, arg in _COLL:
        if key in name:
            return kind, arg
    return None


# DTensor's sharding propagation runs an op once on whole-shaped fake
# tensors the first time it meets its signature: planning, not the step
_PLANNING_FILES = ("_sharding_prop.py", "_op_schema.py")


def _planning(depth: int = 16) -> bool:
    f = sys._getframe(2)
    while f is not None and depth:
        if f.f_code.co_filename.endswith(_PLANNING_FILES):
            return True
        f, depth = f.f_back, depth - 1
    return False


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class StepRecorder(TorchDispatchMode):
    """Records one rank's ops of a step (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.collectives = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
        self.flops = 0
        self.bytes = 0
        self.fused_bytes = 0
        self.live = 0
        self.peak = 0
        self.ops = 0
        self.largest_live: list = []
        self._seen = weakref.WeakSet()
        self._live: dict = {}  # id(storage) → (bytes, op, shape, dtype)
        self._snap = 0

    def _free(self, key: int, n: int) -> None:
        self.live -= n
        self._live.pop(key, None)

    def _allocated(self, func, inputs: list, out) -> None:
        """Each new storage among ``out`` counts as live until it is
        freed; an output that is an input (in place, or an alias) or was
        seen before does not, nor one on the ``meta`` device (a shape
        only: ``specs.from_local`` makes one for its strides)."""
        given = {id(t.untyped_storage()) for t in inputs}
        for t in _tensors(out):
            st = t.untyped_storage()
            if id(st) in given or st in self._seen or t.is_meta:
                continue
            self._seen.add(st)
            n = st.nbytes()
            self.live += n
            self._live[id(st)] = (n, func._overloadpacket.__name__,
                                  tuple(t.shape), str(t.dtype))
            self.peak = max(self.peak, self.live)
            if self.live > self._snap * LARGEST_LIVE_SLACK:
                self._snap = self.live
                self.largest_live = heapq.nlargest(
                    LARGEST_LIVE, self._live.values(), key=lambda e: e[0])
            weakref.finalize(st, self._free, id(st), n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it on this rank's shards
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim" or not _tensors(out) or _planning():
            return out
        self.ops += 1
        coll = _collective(func)
        if coll is not None:
            kind, i = coll
            operand = args[i] if i < len(args) else args[0]
            b = sum(torch_bytes(t) for t in _tensors(operand))
            self.collectives[kind]["count"] += 1
            self.collectives[kind]["bytes"] += b
        if func._overloadpacket in flop_registry:
            self.flops += int(flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
        if func.is_view or func._overloadpacket.__name__ in ("detach",
                                                             "alias"):
            return out
        moved = sum(torch_bytes(t) for t in _tensors((args, kwargs, out)))
        self.bytes += moved
        if coll is not None or func._overloadpacket.__name__ in _MEM_OPS:
            self.fused_bytes += moved
        self._allocated(func, _tensors((args, kwargs)), out)
        return out


def parse_collectives(rec: StepRecorder) -> dict:
    """→ {kind: {"count": int, "bytes": int}}: the collectives ``rec``
    saw, over every kind of ``COLLECTIVES`` (zero where none ran)."""
    return {k: dict(v) for k, v in rec.collectives.items()}


def cost_dict(rec: StepRecorder) -> dict:
    """→ {"flops", "bytes accessed"} of the ops ``rec`` saw."""
    return {"flops": float(rec.flops), "bytes accessed": float(rec.bytes)}


def fused_bytes_estimate(rec: StepRecorder) -> int:
    """Input plus output bytes of the ops ``_MEM_OPS`` names (and the
    collectives): the memory traffic left once elementwise, broadcast and
    reduce chains are fused into their consumers."""
    return rec.fused_bytes
