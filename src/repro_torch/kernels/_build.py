"""Build the CUDA kernels with nvcc at first use, and load them with ctypes.

Each source ``csrc/<name>.cu`` becomes its own shared library with a plain
C interface (``<name>_launch``), compiled for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into ``build/kernels/`` at the
repository root, which git ignores.  The library's file name carries a
hash of its source and of every header in ``csrc/``, so an edited kernel
is rebuilt and a stale one is never loaded.  The first call builds every
missing library at once, one nvcc process per source, all started
together.

Every launch function takes ``c_void_p`` for each pointer and for the
stream, and returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code.  :data:`LAUNCHES` counts the launches each wrapper made,
by kernel (:data:`LAUNCH_NAMES`); wrappers on several host threads (the
thread shards of ``engine/sharded.py``) count through :func:`count_launch`,
under a lock, so every launch is counted exactly once.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("eval_cuts", "locate_leaf", "route_descend", "fused_ingest",
           "query_intersect")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_int64

# argument types of each <name>_launch, in order (csrc/*.cu)
_ARGTYPES = {
    "eval_cuts": [
        P, I64, I32, P, I32,  # records, packed cuts
        P, I32, P,  # in_mask, bits, out
        I32, I32, I32, I32,  # the plan: kernel, warps, smem, most blocks
        P,  # stream
    ],
    "locate_leaf": [
        P, I64, I32,  # predicate matrix
        P, P, P, P, I32, I32, P,  # node arrays, nodes, depth, bids
        I32, I32, I32, I32,  # the plan: kernel, warps, smem, most blocks
        P,  # stream
    ],
    "route_descend": [
        P, I64, I32, P, I32, I32,  # records, nodes, depth
        P, I32, P,  # in_mask, bits, bids
        I32, I32, I32, I32,  # the plan: kernel, warps, smem, most blocks
        P,  # stream
    ],
    "fused_ingest": [
        P, I64, I32, P, I32,  # records, nodes, depth
        P, P, I32, P, P, I32, I32,  # cut table, cat dims, n_adv
        P, P, P, P, P, P, P,  # bids (or null) + accumulators
        I32, I32, I32,  # n_leaves, cw, aw
        I32, I32, I32, I32,  # the plan: kernel, warps, smem, most blocks
        P,  # stream
    ],
    "query_intersect": [
        P, P, I32, P, I32,  # leaf rows, sizes, conjunct rows
        P, P, I32, I32, I32, I32, I32,  # segments and widths
        P, P,  # hits, scanned
        P,  # stream
    ],
}

# argument types of the other entry points a library has
_EXTRA = {
    "eval_cuts": {
        "eval_cuts_plan": [I32] * 4 + [ctypes.POINTER(I32)],  # plan
    },
    "locate_leaf": {
        "locate_leaf_plan": [I32] * 3 + [ctypes.POINTER(I32)],  # plan
    },
    "route_descend": {
        "route_descend_plan": [I32] * 3 + [ctypes.POINTER(I32)],  # plan
    },
    "fused_ingest": {
        "fused_ingest_plan": [I32] * 7 + [ctypes.POINTER(I32)],  # plan
    },
}

# the kernels each launch counter stands for: fused_ingest.cu's two count
# apart, route_descend.cu's two together
LAUNCH_NAMES = ("eval_cuts", "locate_leaf", "route_descend",
                "fused_ingest_shared", "fused_ingest_global",
                "query_intersect")

LAUNCHES: collections.Counter = collections.Counter()  # guarded by: _COUNT_LOCK
_COUNT_LOCK = threading.Lock()

_LIBS: dict[str, ctypes.CDLL] = {}  # guarded by: _LOCK
_LOCK = threading.Lock()
BUILD_SECONDS: dict[str, float] = {}  # guarded by: _LOCK


def count_launch(name: str) -> None:
    """One launch of kernel ``name``: the wrappers call this where they
    launch, and nowhere else."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def launch_counts() -> dict[str, int]:
    with _COUNT_LOCK:
        return {k: LAUNCHES.get(k, 0) for k in LAUNCH_NAMES}


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        LAUNCHES.clear()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels are built from csrc/ at first use"
        )
    return found


def _library_path(name: str) -> pathlib.Path:
    h = hashlib.blake2b(digest_size=6)
    for src in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()}.so"


def _build_missing() -> None:  # qdlint: holds-lock
    """Compile every library not yet on disk, all nvcc runs in parallel."""
    todo = [n for n in KERNELS if not _library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        out = _library_path(name)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT
        ), tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
        BUILD_SECONDS[name] = time.perf_counter() - t0
    if failed:
        details = "\n".join(
            (BUILD_DIR / f"{n}.log").read_text()[-4000:] for n in failed
        )
        raise RuntimeError(f"nvcc failed for {failed}:\n{details}")


def build_all() -> dict[str, float]:
    """Build and load every kernel library; seconds each build took."""
    for name in KERNELS:
        library(name)
    with _LOCK:
        return dict(BUILD_SECONDS)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _build_missing()
            lib = ctypes.CDLL(str(_library_path(name)))
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = _ARGTYPES[name]
            fn.restype = ctypes.c_int
            for entry, argtypes in _EXTRA.get(name, {}).items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


@functools.lru_cache(maxsize=None)
def plan(name: str, device_index: int, *args: int) -> tuple:
    """``<name>_plan(*args)``'s launch plan (kernel, warps a block, shared
    bytes, most blocks) on device ``device_index``, made once a tree shape:
    a batch's launch then makes no host query of the card."""
    import torch

    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device_index):
        rc = getattr(library(name), f"{name}_plan")(*args, out)
    check(rc, name)
    return tuple(out)


def check(rc: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> int:
    return t.data_ptr()
