"""Build the CUDA kernels with nvcc at first use, and load them with ctypes.

Each source ``csrc/<name>.cu`` becomes its own shared library with a plain
C interface (``<name>_launch``), compiled for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into ``build/kernels/`` at the
repository root, which git ignores.  The library's file name carries a
hash of the sources, so an edited kernel is rebuilt and a stale one is
never loaded.  The first call builds every missing library at once, one
nvcc process per source, all started together.

Every launch function takes ``c_void_p`` for each pointer and for the
stream, and returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code.  :data:`LAUNCHES` counts the launches each wrapper made.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("eval_cuts", "locate_leaf", "fused_ingest", "query_intersect")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_int64

# argument types of each <name>_launch, in order (csrc/*.cu)
_ARGTYPES = {
    "eval_cuts": [P, I64, I32, P, P, P, P, I32, I32, P, P, P, P, P],
    "locate_leaf": [P, I64, I32, P, P, P, P, I32, P, P],
    "fused_ingest": [
        P, I64, I32, P, P, P, P, I32, I32, P, P, P,  # records + cut table
        P, P, P, P, I32,  # tree
        P, I32, I32,  # cat dims, n_adv
        P, P, P, P, P, P, P, I32,  # bids + aggregates
        P,  # stream
    ],
    "query_intersect": [
        P, P, P, P, P, P, I32,  # leaves
        P, P, P, P, P, I32,  # conjuncts
        P, I32, P, P, I32, I32, I32, I32, I32,  # layout
        P, P,  # hits, scanned
        P,  # stream
    ],
}

LAUNCHES: collections.Counter = collections.Counter()

_LIBS: dict[str, ctypes.CDLL] = {}  # guarded by: _LOCK
_LOCK = threading.Lock()
BUILD_SECONDS: dict[str, float] = {}  # guarded by: _LOCK


def launch_counts() -> dict[str, int]:
    return {k: LAUNCHES.get(k, 0) for k in KERNELS}


def reset_launch_counts() -> None:
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
    for src in (CSRC / "common.cuh", CSRC / f"{name}.cu"):
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
            _LIBS[name] = lib
        return lib


def check(rc: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> int:
    return t.data_ptr()
