"""The port stands alone: no JAX, no ``repro``, the GPU unless told otherwise."""

import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.engine import LayoutEngine  # noqa: E402
from repro_torch.engine.plan import resolve_device  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "repro" or m.startswith("repro."))
print(len(names), leaked)
print(" ".join(names))
"""

# the sharding and dry-run slices' modules, each among those imported
SHARDING_MODULES = ("repro_torch.launch.mesh", "repro_torch.sharding",
                    "repro_torch.sharding.specs", "repro_torch.train.compress")
DRYRUN_MODULES = ("repro_torch.launch.shapes", "repro_torch.launch.hlo",
                  "repro_torch.launch.dryrun")
# qdlint's, the last slice's
ANALYSIS_MODULES = tuple(f"repro_torch.analysis{m}" for m in (
    "", ".__main__", ".cli", ".core", ".determinism", ".lock_check",
    ".retrace"))


def test_port_imports_neither_jax_nor_repro():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], env=env, capture_output=True,
        text=True, check=True, timeout=120,
    ).stdout.splitlines()
    n_modules, leaked = out[0].split(maxsplit=1)
    # every module of the package was imported: 52 of the layout system,
    # 28 of the LM stack (configs, models, train, launch.{serve_lm,train}),
    # 4 of sharding (launch.mesh, sharding, sharding.specs, train.compress),
    # 3 of the dry-run tier (launch.{shapes,hlo,dryrun}), 7 of qdlint
    # (analysis and its six modules)
    assert int(n_modules) >= 94
    assert set(SHARDING_MODULES + DRYRUN_MODULES + ANALYSIS_MODULES) <= set(
        out[1].split())
    assert leaked.strip() == "[]"


def test_default_device_is_the_gpu():
    from tests.test_torch_kernels import carry_tree, setup_case

    frozen, _ = setup_case(0)
    tree = carry_tree(frozen)
    if torch.cuda.is_available():
        assert LayoutEngine(tree).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LayoutEngine(tree)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
    assert LayoutEngine(tree, device="cpu").device == torch.device("cpu")


def test_kernel_wrappers_launch_or_raise_off_cpu():
    """A CPU tensor takes the plain version; a meta tensor is refused."""
    from repro_torch.kernels import route_records as trk

    with pytest.raises(ValueError, match="unsupported device"):
        trk.eval_cuts(torch.empty((2, 3), dtype=torch.int32, device="meta"),
                      {})


def test_float32_matmul_is_not_tf32():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
