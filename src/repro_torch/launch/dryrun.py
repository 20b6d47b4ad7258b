"""Multi-pod dry-run, as the reference's ``repro.launch.dryrun``.

For every (architecture × input shape) cell this runs the real step
function once on the production mesh — 16×16 single-pod and 2×16×16
multi-pod — as fake DTensors over a fake process group of 256 or 512
ranks, in one process on a host (no card is needed; ``--device cuda``,
the default, makes fake CUDA tensors), and records:

  * the memory account (``_mem_dict``, per device, from the fitted
    shards and ``hlo.StepRecorder``'s live bytes),
  * the cost (``hlo.cost_dict``: FLOPs and unfused bytes),
  * the collective inventory DTensor dispatched (``hlo.parse_collectives``),
  * per-step cost terms extrapolated from 1-group/2-group variants, as
    the reference's, and the full step counted directly
    (``direct_total_flops``: the port loops over its groups).

Nothing is compiled.  Importing this module creates no process group and
sets no environment variable; ``run_cell`` joins the fake group itself.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen1.5-32b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--resume] [--no-cost]

Records go to ``results/dryrun_torch/<arch>__<shape>__<pod>.json``
(``--out``); the port never writes into the reference's ``results/dryrun``.
"""

import argparse
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"


def _cell_json(arch: str, shape: str, multi_pod: bool,
               out: pathlib.Path | None = None) -> pathlib.Path:
    pod = "multipod" if multi_pod else "singlepod"
    return (out or RESULTS) / f"{arch}__{shape}__{pod}.json"


def _mem_dict(mem: dict) -> dict:
    """The reference's five keys of ``memory_analysis()``, per device:

    * ``argument_size_in_bytes``: the arguments' local shards
      (``argument_bytes``; decode's ``pos`` as the reference's int32
      scalar, 4 bytes, where the step reads it);
    * ``output_size_in_bytes``: the outputs' local shards (the updated
      state or caches among them: the port updates them in place);
    * ``temp_size_in_bytes``: the peak of live bytes above the arguments
      while the step runs (``hlo.StepRecorder``: every new storage from its
      allocation to its release, outputs included);
    * ``alias_size_in_bytes``: the donated arguments (the reference's
      ``donate``: the train state, or decode's caches);
    * ``generated_code_size_in_bytes``: 0, nothing is compiled.
    """
    return {
        k: mem[k]
        for k in (
            "argument_size_in_bytes",
            "output_size_in_bytes",
            "temp_size_in_bytes",
            "alias_size_in_bytes",
            "generated_code_size_in_bytes",
        )
    }


def local_bytes(tree, shardings=None) -> int:
    """Per-device bytes of a tree of tensors: each DTensor's local shard,
    each ``meta`` tensor's shard under its ``NamedSharding``, every other
    tensor whole; an int (decode's ``pos``) as an int32 scalar."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves

    from repro_torch.launch import shapes
    from repro_torch.sharding import specs as sh

    if isinstance(tree, int):
        return 4
    if shardings is None:
        return sum(
            (t.to_local() if isinstance(t, DTensor) else t).numel()
            * t.element_size() for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor))
    total = []
    sh.tree_map_specs(lambda t, s: total.append(
        math.prod(shapes._local_shape(tuple(t.shape), s))
        * t.element_size()), tree, shardings)
    return sum(total)


def argument_bytes(cell) -> int:
    """``argument_size_in_bytes`` of a cell, from its shardings alone.
    Decode's ``pos`` counts only where the step reads it: ``jax.jit``
    drops an unused argument from the reference's count, as a pure SSM's
    decode leaves ``pos`` unread."""
    from repro_torch.models import transformer

    cfg = cell.cfg
    reads_pos = cfg.is_encdec or any(
        s.mixer == "attn" for s in transformer.layer_program(cfg))
    return sum(local_bytes(a, s) for a, s in zip(cell.args,
                                                 cell.in_shardings)
               if reads_pos or not isinstance(a, int))


def _join_fake_group(world: int) -> bool:
    """Join a fake process group of ``world`` ranks (as rank 0) unless a
    group exists; → whether this call made it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        return False
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    return True


def _mesh(multi_pod: bool, mesh_shape, device: str):
    from repro_torch.launch import mesh as mesh_lib

    if mesh_shape is None:
        return mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                             device=device)
    if len(mesh_shape) == 3:
        return mesh_lib.make_smoke_mesh(mesh_shape[1], mesh_shape[2],
                                        pod=mesh_shape[0], device=device)
    return mesh_lib.make_smoke_mesh(*mesh_shape, device=device)


def trace(cell, mesh, device: str) -> dict:
    """Run ``cell`` once on fake DTensors under an ``hlo.StepRecorder``:
    → the memory account, the cost and the collectives of one device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import hlo, shapes

    with FakeTensorMode(allow_non_fake_inputs=True):
        args = shapes.place_args(cell, device)
        with hlo.StepRecorder() as rec:
            out = shapes.trace_cell(cell, mesh, args)
        arg_b = argument_bytes(cell)
        mem = {
            "argument_size_in_bytes": arg_b,
            "output_size_in_bytes": local_bytes(out),
            "temp_size_in_bytes": rec.peak,
            "alias_size_in_bytes": sum(local_bytes(args[i])
                                       for i in cell.donate),
            "generated_code_size_in_bytes": 0,
        }
        del out, args
    return {"memory": mem, "peak_bytes": arg_b + rec.peak,
            "cost": hlo.cost_dict(rec),
            "fused_bytes": hlo.fused_bytes_estimate(rec),
            "collectives": hlo.parse_collectives(rec), "ops": rec.ops,
            "largest_live": [
                {"op": op, "shape": list(shape), "dtype": dtype, "bytes": n}
                for n, op, shape, dtype in rec.largest_live]}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             with_cost: bool = True, cost_only: bool = False,
             device: str = "cuda", out: pathlib.Path | None = None,
             mesh_shape: tuple | None = None) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import hlo
    from repro_torch.launch.shapes import build_cell
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer

    cfg = get_config(arch)
    world = math.prod(mesh_shape) if mesh_shape else (
        512 if multi_pod else 256)
    made = _join_fake_group(world)
    try:
        mesh = _mesh(multi_pod, mesh_shape, device)
        n_chips = mesh.size()
        record = {
            "arch": arch, "shape": shape_name,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "chips": n_chips,
            "torch_version": torch.__version__,
            "device": device,
        }

        if cost_only:
            # refresh cost_terms on an existing record (skip the full run)
            prev = _cell_json(arch, shape_name, multi_pod, out)
            if prev.exists():
                record = json.loads(prev.read_text())
        else:
            # ---- full fidelity: every layer group, real chunking --------
            t0 = time.perf_counter()
            cell = build_cell(cfg, shape_name, mesh)
            t_build = time.perf_counter() - t0
            t0 = time.perf_counter()
            full = trace(cell, mesh, device)
            t_trace = time.perf_counter() - t0
            print(full["memory"])
            print(full["cost"])
            record.update(
                step=cell.step_name,
                lower_s=round(t_build, 2),
                compile_s=round(t_trace, 2),
                memory=_mem_dict(full["memory"]),
                peak_bytes=full["peak_bytes"],
                cost_scanned=full["cost"],
                collectives_scanned=full["collectives"],
                hlo_bytes=None,  # no HLO: ``ops`` counts the dispatched ops
                ops=full["ops"],
                largest_live=full["largest_live"],
            )

        # ---- per-step cost terms via 1g/2g extrapolation ----------------
        if with_cost:
            period = (
                1 if cfg.is_encdec
                else len(transformer.layer_program(cfg))
            )
            ng = (
                cfg.n_layers if cfg.is_encdec else transformer.n_groups(cfg)
            )
            samples = {}
            for g in (1, 2):
                vcfg = dataclasses.replace(
                    cfg,
                    n_layers=period * g,
                    encoder_layers=(g if cfg.is_encdec
                                    else cfg.encoder_layers),
                    scan_unroll=True,
                    attn_chunk=8192,
                    ssd_chunk=2048,
                    # count the full batch in one pass, as the reference
                    microbatches=1,
                )
                c = trace(build_cell(vcfg, shape_name, mesh), mesh, device)
                samples[g] = {
                    "peak_bytes": c["peak_bytes"],
                    "flops": c["cost"]["flops"],
                    "bytes": c["cost"]["bytes accessed"],
                    "fused_bytes": float(c["fused_bytes"]),
                    "coll_bytes": float(
                        hlo.total_collective_bytes(c["collectives"])),
                    "coll": c["collectives"],
                }
            keys = ("flops", "bytes", "fused_bytes", "coll_bytes")
            body = {k: samples[2][k] - samples[1][k] for k in keys}
            outside = {k: max(samples[1][k] - body[k], 0.0)
                       for k in body}
            total = {k: outside[k] + ng * max(body[k], 0.0) for k in body}
            direct = record.get("cost_scanned", {}).get("flops")
            record["cost_terms"] = {
                "per_group": body,
                "outside": outside,
                "n_groups": ng,
                "total_flops": total["flops"],
                "total_bytes": total["bytes"],
                "total_fused_bytes": total["fused_bytes"],
                "total_collective_bytes": total["coll_bytes"],
                "collectives_1g": samples[1]["coll"],
                "collectives_2g": samples[2]["coll"],
                "peak_bytes_1g": samples[1]["peak_bytes"],
                "peak_bytes_2g": samples[2]["peak_bytes"],
                # the full step, counted as it runs (None: not run here)
                "direct_total_flops": direct,
            }
            record["model_flops"] = model_lib.model_flops_per_token(cfg)
        return record
    finally:
        if made:
            dist.destroy_process_group()


def _mesh_arg(text: str) -> tuple:
    shape = tuple(int(x) for x in text.split(","))
    if len(shape) not in (2, 3):
        raise argparse.ArgumentTypeError("--mesh is D,M or P,D,M")
    return shape


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose result JSON already exists")
    ap.add_argument("--no-cost", action="store_true",
                    help="skip the cost-extrapolation variants")
    ap.add_argument("--cost-only", action="store_true",
                    help="recompute cost_terms on existing records only")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (no card is needed)")
    ap.add_argument("--out", type=pathlib.Path, default=RESULTS,
                    help="directory of the records")
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all: cells run at once, one subprocess each")
    ap.add_argument("--mesh", type=_mesh_arg, default=None,
                    help="another mesh than the production ones: D,M or "
                         "P,D,M (a fake group of that many ranks)")
    args = ap.parse_args(argv)

    args.out.mkdir(parents=True, exist_ok=True)

    if args.all:
        # one subprocess per cell: a fresh fake group and memory each
        from repro_torch.configs import runnable_cells

        cells = [
            (a, s, mp)
            for (a, s) in runnable_cells()
            for mp in (False, True)
        ]
        todo = []
        for arch, shape, mp in cells:
            out = _cell_json(arch, shape, mp, args.out)
            if args.resume and out.exists():
                print(f"skip {out.name}")
                continue
            cmd = [
                sys.executable, "-m", "repro_torch.launch.dryrun",
                "--arch", arch, "--shape", shape, "--device", args.device,
                "--out", str(args.out),
            ]
            if mp:
                # the cost table is single-pod, as the reference's; the
                # multi-pod pass proves the pod axis shards + reports memory
                cmd += ["--multi-pod", "--no-cost"]
            if args.no_cost and "--no-cost" not in cmd:
                cmd.append("--no-cost")
            todo.append(((arch, shape, mp), cmd))

        def one(item):
            (arch, shape, mp), cmd = item
            print(f"=== {arch} × {shape} × "
                  f"{'multi' if mp else 'single'}pod ===", flush=True)
            t0 = time.perf_counter()
            try:
                code = subprocess.run(cmd, timeout=3600).returncode
            except subprocess.TimeoutExpired:
                code = -1
                print("TIMEOUT")
            return {"arch": arch, "shape": shape,
                    "pod": "multi" if mp else "single", "rc": code,
                    "seconds": round(time.perf_counter() - t0, 2)}

        with ThreadPoolExecutor(args.jobs) as pool:
            status = list(pool.map(one, todo))
        failed = [(s["arch"], s["shape"], s["pod"]) for s in status
                  if s["rc"]]
        (args.out / "status.json").write_text(json.dumps(status, indent=1))
        print(f"done; {len(failed)} failures: {failed}")
        sys.exit(1 if failed else 0)

    record = run_cell(
        args.arch, args.shape, args.multi_pod,
        with_cost=not args.no_cost, cost_only=args.cost_only,
        device=args.device, out=args.out, mesh_shape=args.mesh,
    )
    out = _cell_json(args.arch, args.shape, args.multi_pod, args.out)
    out.write_text(json.dumps(record, indent=1))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
