"""The port's dry-run tier (``repro_torch.launch.{shapes,hlo,dryrun}``)
against the reference's, on the CPU.

The reference's side runs in subprocesses with host devices (512 for the
production meshes' abstract cells, 8 for the compiled memory analyses of
reduced cells, XLA's backend optimizations off: argument sizes do not
depend on them), started together when the file's first test runs and
read by the tests that need them.  The port's cells are built on a
stand-in mesh (only its axis sizes are read) or traced on fake tensors
over a fake process group, joined and destroyed within each test, so no
later test in the worker finds a default group.  Fake tensors are on the
CPU here: a CPU-only torch cannot run autograd on fake CUDA tensors.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import hlo as jhlo  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch import dryrun, hlo, shapes  # noqa: E402
from repro_torch.models import model  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF_TIMEOUT_S = 300

# the small shapes of the reduced cells, both packages
SMALL = {"train_4k": ("train_4k", 64, 8, "train"),
         "prefill_32k": ("prefill_32k", 64, 8, "prefill"),
         "decode_32k": ("decode_32k", 64, 8, "decode"),
         "long_500k": ("long_500k", 128, 1, "decode")}
MEM_ARCHS = ("qwen1.5-32b", "qwen3-moe-235b-a22b", "mamba2-780m")
MEM_MESHES = {"2x2": {"data": 2, "model": 2},
              "2x2x2": {"pod": 2, "data": 2, "model": 2}}
PROD_MESHES = {"single": {"data": 16, "model": 16},
               "multi": {"pod": 2, "data": 16, "model": 16}}
# the train step's matmul FLOPs against model_flops_per_token × tokens
# (6N a token): attention's score and value products (4·S·d a layer and
# token, forward and backward) come on top, and the embedding lookup, a
# gather, counts none of its 6·vocab·d; the reduced qwen1.5-32b at S = 64
# lands at 1.052×
MODEL_FLOPS_RTOL = 0.10

_REF_CELLS = """
import json
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config, runnable_cells
from repro.launch.shapes import build_cell

devs = np.array(jax.devices())
meshes = {"single": Mesh(devs[:256].reshape(16, 16), ("data", "model")),
          "multi": Mesh(devs.reshape(2, 16, 16), ("pod", "data", "model"))}

def spec(s):
    if s is None:
        return None
    return [list(e) if isinstance(e, tuple) else e for e in s.spec]

out = {}
for arch, shape in runnable_cells():
    for name, mesh in meshes.items():
        c = build_cell(get_config(arch), shape, mesh)
        leaves = []
        for i, (a, s) in enumerate(zip(c.args, c.in_shardings)):
            flat = jax.tree_util.tree_flatten_with_path(a)[0]
            shs = (jax.tree.leaves(s, is_leaf=lambda x: hasattr(x, "spec"))
                   if s is not None else [None] * len(flat))
            for (path, leaf), sh in zip(flat, shs):
                leaves.append([i, jax.tree_util.keystr(path),
                               list(leaf.shape), str(leaf.dtype), spec(sh)])
        out[f"{arch}|{shape}|{name}"] = {
            "step": c.step_name, "donate": list(c.donate), "leaves": leaves}
print(json.dumps(out))
"""

_REF_MEM = """
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.configs import base
from repro.launch import shapes

small, archs = json.loads(sys.argv[1]), json.loads(sys.argv[2])
shapes.SHAPES = {k: base.InputShape(*v) for k, v in small.items()}
devs = np.array(jax.devices())
meshes = {"2x2": Mesh(devs[:4].reshape(2, 2), ("data", "model")),
          "2x2x2": Mesh(devs.reshape(2, 2, 2), ("pod", "data", "model"))}
out = {}
for arch in archs:
    cfg = get_config(arch).reduced()
    for shape in small:
        if shape == "long_500k" and cfg.family not in ("ssm", "hybrid"):
            continue
        for name, mesh in meshes.items():
            c = shapes.build_cell(cfg, shape, mesh)
            comp = shapes.lower_cell(c, mesh).compile()
            out[f"{arch}|{shape}|{name}"] = \\
                comp.memory_analysis().argument_size_in_bytes
print(json.dumps(out))
"""


def _reference(code: str, devices: int, *args) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices} "
                        "--xla_backend_optimization_level=0 "
                        "--xla_llvm_disable_expensive_passes=true"}
    return subprocess.Popen([sys.executable, "-c", code, *args], cwd=ROOT,
                            env=env, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)


@pytest.fixture(scope="module")
def references():
    """Both reference subprocesses, started together; each read once."""
    procs = {"cells": _reference(_REF_CELLS, 512),
             "mem": _reference(_REF_MEM, 8, json.dumps(SMALL),
                               json.dumps(MEM_ARCHS))}
    got: dict = {}

    def read(name):
        if name not in got:
            out, err = procs[name].communicate(timeout=REF_TIMEOUT_S)
            assert procs[name].returncode == 0, err[-3000:]
            got[name] = json.loads(out.strip().splitlines()[-1])
        return got[name]

    yield read
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


class _Mesh:
    """A stand-in mesh: the axis sizes that fitting a spec reads."""

    def __init__(self, shape: dict):
        self.shape = shape

    @property
    def axis_names(self):
        return tuple(self.shape)


def _spec(s) -> list | None:
    if s is None:
        return None
    return [list(e) if isinstance(e, tuple) else e for e in s.spec]


def _flat(tree, shardings, path=""):
    """(path, shape, dtype, spec) of each leaf, a layer stack stacked as
    the reference's (its leading dim unsplit)."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], shardings[k], f"{path}['{k}']")
    elif isinstance(tree, list):
        groups = [list(_flat(t, s, path)) for t, s in zip(tree, shardings)]
        for entries in zip(*groups):
            p, shape, dt, spec = entries[0]
            assert all(e == entries[0] for e in entries)
            yield p, [len(tree)] + shape, dt, [None] + spec
    elif isinstance(tree, int):  # decode's pos: the reference's int32
        yield path, [], "int32", None
    else:
        yield (path, list(tree.shape), str(tree.dtype).replace("torch.", ""),
               _spec(shardings))


def _port_cell(cell) -> dict:
    leaves = []
    for i, (a, s) in enumerate(zip(cell.args, cell.in_shardings)):
        leaves += [[i, *e] for e in _flat(a, s)]
    return {"step": cell.step_name, "donate": list(cell.donate),
            "leaves": sorted(leaves)}  # JAX flattens dicts in key order


def test_build_cell_equals_the_reference_on_the_production_meshes(
        references):
    """Every runnable cell on 16×16 and 2×16×16: the step, the donated
    arguments, and each argument leaf's shape, dtype and fitted spec equal
    ``repro.launch.shapes.build_cell``'s (abstract only, no compile)."""
    want = references("cells")
    cells = tconfigs.runnable_cells()
    assert len(want) == 2 * len(cells)
    for arch, shape in cells:
        for name, mesh in PROD_MESHES.items():
            got = _port_cell(shapes.build_cell(tconfigs.get_config(arch),
                                               shape, _Mesh(mesh)))
            ref = want[f"{arch}|{shape}|{name}"]
            ref["leaves"] = sorted(ref["leaves"])
            assert got == ref, (arch, shape, name)


@pytest.fixture
def small_shapes(monkeypatch):
    monkeypatch.setattr(shapes, "SHAPES", {
        k: tbase.InputShape(*v) for k, v in SMALL.items()})


def test_argument_bytes_equal_the_references_memory_analysis(
        references, small_shapes):
    """Reduced dense, MoE and SSM archs in each shape kind on (2, 2) and
    (2, 2, 2): the per-device bytes of the arguments' fitted shards equal
    the reference's ``compiled.memory_analysis().argument_size_in_bytes``
    exactly."""
    want = references("mem")
    n = 0
    for arch in MEM_ARCHS:
        cfg = tconfigs.get_config(arch).reduced()
        for shape in SMALL:
            if shape == "long_500k" and cfg.family not in ("ssm", "hybrid"):
                continue
            for name, mesh in MEM_MESHES.items():
                cell = shapes.build_cell(cfg, shape, _Mesh(mesh))
                assert dryrun.argument_bytes(cell) == \
                    want[f"{arch}|{shape}|{name}"], (arch, shape, name)
                n += 1
    assert n == len(want) == 20


@pytest.fixture
def reduced_arch(monkeypatch, small_shapes):
    """``qwen1.5-32b`` as its ``reduced()`` config (remat off with the
    param), at the small shapes."""
    def use(**over):
        cfg = tconfigs.get_config("qwen1.5-32b").reduced(**over)
        monkeypatch.setitem(tconfigs.ARCHS, "qwen1.5-32b", cfg)
        return cfg
    return use


def test_direct_flops_equal_the_extrapolation_and_the_model_flops(
        reduced_arch):
    """A reduced dense train cell on a one-rank fake mesh: the full step
    counted directly equals the reference's 1g/2g extrapolation, with
    remat and without; without remat the FLOPs are within
    MODEL_FLOPS_RTOL of ``model_flops_per_token`` × tokens (6N a token),
    with remat the forward is counted twice."""
    flops = {}
    for remat in (True, False):
        cfg = reduced_arch(remat=remat)
        rec = dryrun.run_cell("qwen1.5-32b", "train_4k", False,
                              device="cpu", mesh_shape=(1, 1))
        terms = rec["cost_terms"]
        assert terms["direct_total_flops"] == terms["total_flops"]
        assert terms["n_groups"] == cfg.n_layers
        flops[remat] = terms["direct_total_flops"]
    tokens = SMALL["train_4k"][1] * SMALL["train_4k"][2]
    want = model.model_flops_per_token(cfg) * tokens
    assert abs(flops[False] / want - 1) < MODEL_FLOPS_RTOL
    assert flops[False] < flops[True] < 1.5 * flops[False]
    assert not torch.distributed.is_initialized()


def test_one_all_gather_is_recorded_with_its_local_bytes():
    """A matmul of a row-split (``data``) matrix by a column-split
    (``model``) one on a fake (2, 2) mesh runs on each rank's shards with
    no collective; redistributing its product to rows only gathers its
    columns over ``model``: one all-gather of the local (8, 4) float32
    shard, and nothing else is collective."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dryrun._join_fake_group(4)
    try:
        mesh = dryrun._mesh(False, (2, 2), "cpu")
        with FakeTensorMode():
            a = DTensor.from_local(torch.empty(8, 16), mesh,
                                   (Shard(0), Replicate()), run_check=False)
            b = DTensor.from_local(torch.empty(16, 4), mesh,
                                   (Replicate(), Shard(1)), run_check=False)
            with hlo.StepRecorder() as rec:
                c = (a @ b).redistribute(mesh, (Shard(0), Replicate()))
            assert tuple(c.to_local().shape) == (8, 8)
    finally:
        dist.destroy_process_group()
    coll = hlo.parse_collectives(rec)
    assert coll["all-gather"] == {"count": 1, "bytes": 8 * 4 * 4}
    assert sum(v["count"] for v in coll.values()) == 1
    assert hlo.total_collective_bytes(coll) == 128
    assert rec.flops == 2 * 8 * 16 * 4  # the local product


@pytest.mark.parametrize("dtype,dims", [
    ("f32", "16,16"), ("bf16", "8,128,3"), ("s8", ""), ("pred", "7"),
    ("u4", "2,2"), ("f8e4m3fn", "5"), ("c128", "1"), ("s64", "3,3"),
    ("nope", "4"),
])
def test_tensor_bytes_equal_the_reference(dtype, dims):
    assert hlo.tensor_bytes(dtype, dims) == jhlo.tensor_bytes(dtype, dims)
    coll = {k: {"count": i, "bytes": 7 * i + len(dims)}
            for i, k in enumerate(hlo.COLLECTIVES)}
    assert hlo.total_collective_bytes(coll) == \
        jhlo.total_collective_bytes(coll)
    assert hlo.COLLECTIVES == jhlo.COLLECTIVES
    assert hlo.DTYPE_BYTES == jhlo.DTYPE_BYTES


def test_torch_dtypes_map_onto_the_references_names():
    for dt, name in hlo.XLA_DTYPES.items():
        assert torch.empty(0, dtype=dt).element_size() == \
            jhlo.DTYPE_BYTES[name]


_REF_RECORD_KEYS = {"arch", "shape", "mesh", "chips", "step", "lower_s",
                    "compile_s", "memory", "cost_scanned",
                    "collectives_scanned", "hlo_bytes", "cost_terms",
                    "model_flops"}  # and jax_version, as torch_version
_REF_COST_KEYS = {"per_group", "outside", "n_groups", "total_flops",
                  "total_bytes", "total_fused_bytes",
                  "total_collective_bytes", "collectives_1g",
                  "collectives_2g"}


def test_cli_writes_a_record_with_the_references_keys(tmp_path):
    """``python -m repro_torch.launch.dryrun`` for starcoder2-3b ×
    decode_32k at full width on the fake 16×16 mesh, with the cost
    variants: exit 0, a record in ``--out`` with every key of the
    reference's record (``torch_version`` for ``jax_version``), its
    memory keys, a finite per-device peak and all five collective kinds
    in each inventory."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "starcoder2-3b", "--shape", "decode_32k", "--device", "cpu",
         "--out", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=REF_TIMEOUT_S,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads((tmp_path / "starcoder2-3b__decode_32k__singlepod.json")
                     .read_text())
    assert _REF_RECORD_KEYS | {"torch_version"} <= set(rec)
    assert _REF_COST_KEYS | {"direct_total_flops"} <= set(rec["cost_terms"])
    assert set(rec["memory"]) == set(dryrun._mem_dict(rec["memory"]))
    assert rec["mesh"] == {"data": 16, "model": 16} and rec["chips"] == 256
    assert rec["step"] == "serve_step"
    assert 0 < rec["peak_bytes"] < 80e9 and np.isfinite(rec["peak_bytes"])
    for inv in (rec["collectives_scanned"],
                rec["cost_terms"]["collectives_1g"]):
        assert set(inv) == set(jhlo.COLLECTIVES)


# the 1-group variant's per-device peak before attention's query heads were
# split over ``model``: the ``trace`` of the same variant on the tree before
# the split, fake CPU tensors.  It is the same with ``StepRecorder``
# skipping ``meta`` tensors (the accounting now) or not, and the tree of
# the split with the split turned off, all its other memory repairs in
# place, comes to exactly it: the peak is the core's float32 scores of all
# 48 query heads on every rank ((16, 4, 12, 4096, 4096), 51.5 GB).  So
# the bound guards the head split.
PARENT_PEAK_1G = {("starcoder2-15b", "train_4k"): 162_135_441_436}
# the query heads attention's core sees on a rank: ceil(h / 16) of a
# train step's (24 and 48 heads over 2 and 4 KV heads, 16 not dividing
# either's KV heads); decode's cached path and mamba2 run no such core
CORE_HEADS = {("starcoder2-3b", "train_4k"): [2],
              ("starcoder2-15b", "train_4k"): [3]}


@pytest.mark.parametrize("arch,shape", [
    ("starcoder2-3b", "train_4k"), ("starcoder2-3b", "decode_32k"),
    ("mamba2-780m", "train_4k"), ("starcoder2-15b", "train_4k"),
])
def test_one_group_variant_traces_at_full_width_on_16x16(arch, shape,
                                                        monkeypatch):
    """The production-mesh regression: the 1-group cost variant of each
    cell at its published widths runs on fake DTensors over a fake
    256-rank (16, 16) mesh (24 heads and 2 KV heads on a 16-way ``model``
    axis; mamba2's SSD over split heads; 48 heads and 4 KV heads, split 3
    query heads a rank, below the parent's peak)."""
    import torch.distributed as dist

    from repro_torch.models import attention, transformer

    seen = []
    for name in ("full_attention", "chunked_attention"):
        def watched(q, *a, _core=getattr(attention, name), **k):
            seen.append(q.shape[2] * q.shape[3])  # (B, S, KV, rep, hd)
            return _core(q, *a, **k)
        monkeypatch.setattr(attention, name, watched)

    cfg = tconfigs.get_config(arch)
    vcfg = dataclasses.replace(
        cfg, n_layers=len(transformer.layer_program(cfg)), attn_chunk=8192,
        ssd_chunk=2048, microbatches=1)
    dryrun._join_fake_group(256)
    try:
        mesh = dryrun._mesh(False, None, "cpu")
        got = dryrun.trace(shapes.build_cell(vcfg, shape, mesh), mesh, "cpu")
    finally:
        dist.destroy_process_group()
    assert got["cost"]["flops"] > 0 and got["peak_bytes"] > 0
    assert got["memory"]["argument_size_in_bytes"] > 0
    assert sorted(set(seen)) == CORE_HEADS.get((arch, shape), [])
    if (arch, shape) in PARENT_PEAK_1G:
        assert got["peak_bytes"] < PARENT_PEAK_1G[arch, shape]


# the same variants' per-device peaks on the tree before prefill's caches
# were laid out as decode's and the embedding looked up on each rank's vocab
# slice (fake CPU tensors): prefill's two groups at the cost variants'
# chunking hold the first group's caches whole over 40 KV heads
# ((2, 2, 40, 32768, 128) bf16 for k and for v) through the second
# group's attention; the train step's one group, at the config's own
# chunking and two microbatches, peaks at the embedding's gradient, three
# float32 copies of the whole (152064, 5120) table.  A one-group prefill
# peaks in its attention before its caches are written, the same on both
# trees (10,003,689,476 B).
PARENT_PEAK_RELAYOUT = {("prefill_32k", 2): 12_762_877_956,
                        ("train_4k", 1): 11_393_867_812}


@pytest.mark.parametrize("shape,groups", sorted(PARENT_PEAK_RELAYOUT))
def test_qwen_32b_holds_no_whole_cache_or_table_on_16x16(shape, groups):
    """qwen1.5-32b at its published widths on the fake 16×16 mesh, whose
    16-way ``model`` axis divides neither its 40 KV heads nor leaves its
    152,064-word table whole: prefill's caches split along the sequence,
    the embedding's table and gradient on each rank's vocab slice.  Each
    variant's peak is below the parent's, and no storage among the
    largest live at it is a whole cache or a whole table."""
    import torch.distributed as dist

    cfg = tconfigs.get_config("qwen1.5-32b")
    vcfg = dataclasses.replace(cfg, n_layers=groups)
    if shape == "prefill_32k":
        vcfg = dataclasses.replace(vcfg, attn_chunk=8192, microbatches=1)
    dryrun._join_fake_group(256)
    try:
        mesh = dryrun._mesh(False, None, "cpu")
        got = dryrun.trace(shapes.build_cell(vcfg, shape, mesh), mesh, "cpu")
    finally:
        dist.destroy_process_group()
    assert 0 < got["peak_bytes"] < PARENT_PEAK_RELAYOUT[shape, groups]
    for t in got["largest_live"]:
        assert t["shape"][-3:] != [cfg.n_kv_heads, 32768, cfg.hd], t
        assert t["shape"] != [cfg.vocab, cfg.d_model], t


def test_importing_the_dryrun_sets_up_nothing():
    code = textwrap.dedent("""
        import os, torch.distributed as dist
        before = dict(os.environ)
        from repro_torch.launch import dryrun, hlo, shapes
        assert not dist.is_initialized()
        assert dict(os.environ) == before
        print("IMPORT OK")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0 and "IMPORT OK" in r.stdout, r.stderr[-2000:]
