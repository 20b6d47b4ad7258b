"""Multi-rank helpers for the port's sharding tests: ``gloo`` ranks on the
CPU, each a spawned process, joined by a ``file://`` store in the test's
temp dir (no TCP port), with a timeout of their own.

This module imports torch and the port only: a spawned rank re-imports it,
and neither JAX nor ``repro`` is loaded there.  Each rank's result is
pickled into the temp dir and read back by ``run_ranks``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import multiprocessing
import os
import pickle
import time
import traceback

import numpy as np


def run_ranks(target, world: int, tmp, timeout: float, **kw) -> list:
    """``target(rank, world, **kw)`` on ``world`` spawned ranks in one
    gloo process group; → each rank's return value, in rank order.
    Raises with the failing rank's traceback, or when the ranks outlive
    ``timeout`` seconds (all are killed)."""
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(str(tmp), f"store_{target.__name__}")
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world, store, str(tmp), kw))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.1))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
    results = []
    for r in range(world):
        path = os.path.join(str(tmp), f"rank_{target.__name__}_{r}.pkl")
        if not os.path.exists(path):
            raise RuntimeError(f"rank {r} of {target.__name__} left no result"
                               + (" (timed out)" if alive else ""))
        with open(path, "rb") as f:
            ok, value = pickle.load(f)
        if not ok:
            raise RuntimeError(f"rank {r} of {target.__name__}:\n{value}")
        results.append(value)
    return results


def _rank_main(target, rank, world, store, tmp, kw):
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group

    torch.set_num_threads(1)
    out = (False, "did not finish")
    try:
        init_process_group("cpu", init_method=f"file://{store}", rank=rank,
                           world_size=world, timeout_s=240)
        out = (True, target(rank, world, **kw))
    except BaseException:  # noqa: BLE001 - reported to the parent
        out = (False, traceback.format_exc())
    finally:
        with open(os.path.join(tmp, f"rank_{target.__name__}_{rank}.pkl"),
                  "wb") as f:
            pickle.dump(out, f)
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# shared by the ranks
# ---------------------------------------------------------------------------
ARCH = "qwen1.5-32b"
BATCH_SPEC = {"tokens": ("batch", None), "labels": ("batch", None)}


def step_batch(vocab: int, seed: int = 0, b: int = 8, s: int = 32,
               frames: tuple | None = None) -> dict:
    """The reference tests' batch: tokens and next tokens, from numpy;
    with ``frames`` (n, d_model) an enc-dec's stub frame embeddings too."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    if frames is not None:
        batch["frames"] = (0.01 * rng.standard_normal(
            (b,) + tuple(frames))).astype(np.float32)
    return batch


def _tensors(batch: dict) -> dict:
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _mesh(shape):
    from repro_torch.launch.mesh import make_smoke_mesh

    if len(shape) == 3:
        return make_smoke_mesh(shape[1], shape[2], pod=shape[0],
                               device="cpu")
    return make_smoke_mesh(*shape, device="cpu")


def _host(tree):
    """A state tree as the reference's numpy layout, each leaf whole."""
    from repro_torch.models import model
    from repro_torch.sharding import specs as sh

    return model.state_to_jax(model.tree_map(sh.full, tree))


# ---------------------------------------------------------------------------
# 4 ranks: the (2, 2) train step, elastic checkpoints, the train CLI
# ---------------------------------------------------------------------------
def mesh_ranks(rank, world, ref_ckpt, port_ckpt, cli_ckpt, cli_args):
    """On a (2 data × 2 model) mesh: one sharded train step from the
    reference's checkpoint (and, on rank 0, the one-device step from the
    same state); the port's sharded save, restored onto (4, 1) and onto
    one device; the reference's checkpoint restored onto (2, 2); the
    train CLI at ``cli_args``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as ttrain
    from repro_torch.models import common
    from repro_torch.sharding import specs as sh
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import steps
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.schedule import ScheduleConfig

    cfg = get_config(ARCH).reduced(n_layers=2)
    ocfg, scfg = AdamWConfig(), ScheduleConfig(peak_lr=1e-3,
                                               warmup_steps=2)
    rules = sh.Rules.make()
    batch = _tensors(step_batch(cfg.vocab))
    mesh = _mesh((2, 2))
    out = {}

    # the train step, sharded and (rank 0) on one device, from one state
    step, shapes, ssh, bsh = steps.jit_train_step(
        cfg, ocfg, scfg, mesh, rules, batch, BATCH_SPEC)
    state = ckpt.restore_checkpoint(ref_ckpt, 0, shapes, "cpu", ssh)
    out["ref_restored"] = _host(state)
    for _ in range(2):  # lr is 0 at step 0: the second step moves params
        state, m = step(state, sh.place(batch, bsh))
        out.setdefault("sharded_losses", []).append(float(m["loss"]))
        out.setdefault("grad_norm0", float(m["grad_norm"]))
    out["sharded_params"] = _host(state["params"])
    if rank == 0:
        one = ckpt.restore_checkpoint(ref_ckpt, 0, shapes, "cpu")
        for _ in range(2):
            one, m = steps.train_step(one, batch, cfg, ocfg, scfg)
            out.setdefault("one_losses", []).append(float(m["loss"]))
        out["one_params"] = _host(one["params"])

    # 2 microbatches, accumulated into DTensors laid out as the params
    cfg2 = dataclasses.replace(cfg, microbatches=2)
    step2, _, _, _ = steps.jit_train_step(cfg2, ocfg, scfg, mesh, rules,
                                          batch, BATCH_SPEC)
    st2 = ckpt.restore_checkpoint(ref_ckpt, 0, shapes, "cpu", ssh)
    _, m2 = step2(st2, sh.place(batch, bsh))
    out["microbatch_metrics"] = {k: float(v) for k, v in m2.items()}

    out["adamw_int8"] = _adamw_int8(mesh)

    # elastic: saved on (2, 2), restored onto (4, 1) and one device
    fresh = sh.place(steps.init_train_state(
        common.make_generator(0, "cpu"), cfg, ocfg), ssh)
    ckpt.save_checkpoint(port_ckpt, 5, fresh)
    want = _host(fresh)
    shapes_b, specs_b = steps.abstract_state(cfg, ocfg)
    sh_b = sh.fitted_shardings(shapes_b, specs_b, _mesh((4, 1)), rules)
    on_b = ckpt.restore_checkpoint(port_ckpt, 5, shapes_b, "cpu", sh_b)
    on_one = ckpt.restore_checkpoint(port_ckpt, 5, shapes_b, "cpu")
    out["elastic_sharded"] = any(isinstance(x, sh.DTensor) for x in
                                 _leaves(on_b))
    out["elastic_equal"] = [_tree_equal(want, _host(t))
                            for t in (on_b, on_one)]

    # the train CLI on this mesh, resuming from the reference's state
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ttrain.main(cli_args + ["--ckpt-dir", cli_ckpt])
    if rank == 0:
        out["cli"] = json.loads(buf.getvalue().strip().splitlines()[-1])
    torch.distributed.barrier()
    return out


def _adamw_int8(mesh) -> dict:
    """Two int8-moment AdamW updates of a stacked matrix and a vector,
    plain and as DTensors whose rows are split over ``model`` (the row
    absmax then spans ranks): each leaf's whole params and moments.  The
    clip is off: the global norm sums its shards in another order, which
    would move every value by a rounding."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import model
    from repro_torch.sharding import specs as sh
    from repro_torch.train import optimizer as opt

    ocfg = opt.AdamWConfig(eight_bit=True, max_grad_norm=1e9)
    rng = np.random.default_rng(5)
    draw = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    params = {"w": draw(8, 16), "layers": [{"s": draw(16)}]}
    grads = [{"w": draw(8, 16), "layers": [{"s": draw(16)}]}
             for _ in range(2)]

    def place(t):
        """Rows over data (a matrix's), the last axis over model (a row
        scale's whole)."""
        pl = (Shard(0) if t.dim() >= 2 else Replicate(),
              Shard(t.dim() - 1) if t.shape[-1] > 1 else Replicate())
        return distribute_tensor(t, mesh, pl, src_data_rank=None)

    out = {}
    for sharded in (False, True):
        p = model.tree_map(torch.clone, params)
        st = opt.adamw_init(p, ocfg)
        if sharded:
            p = model.tree_map(place, p)
            st = dict(st, m=model.tree_map(place, st["m"]),
                      v=model.tree_map(place, st["v"]))
        with implicit_replication():
            for g in grads:
                g = model.tree_map(place, g) if sharded else g
                p, st, _ = opt.adamw_update(p, g, st, 1e-2, ocfg)
        out[sharded] = model.tree_map(
            lambda t: sh.full(t).numpy(), {"p": p, "m": st["m"],
                                            "v": st["v"]})
    return out


def _leaves(tree):
    from repro_torch.models import model

    return list(model.leaves(tree))


def _tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k])
                                            for k in a)
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


# ---------------------------------------------------------------------------
# 8 ranks: the MoE's EP and ff paths
# ---------------------------------------------------------------------------
MOE_CASES = {"ep": ("qwen3-moe-235b-a22b",
                    {"n_experts": 4, "top_k": 2, "capacity_factor": 8.0}),
             "ff": ("grok-1-314b", {"capacity_factor": 8.0})}


def moe_ranks(rank, world, params_np: dict, x_np: dict):
    """Each MoE case under a (2 pod, 2 data, 2 model) mesh and alone
    (``_moe_local``), from the reference's weights: y, aux and the grads
    of mean(y²) + aux by the weights and the input."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import mlp
    from repro_torch.sharding import specs as sh

    mesh = _mesh((2, 2, 2))
    out = {}
    for case, (arch, over) in MOE_CASES.items():
        cfg = get_config(arch).reduced(**over)
        params = {k: torch.from_numpy(v) for k, v in params_np[case].items()}
        x = torch.from_numpy(x_np[case])
        res = {}
        for sharded in (False, True):
            ps = {k: v.clone().requires_grad_() for k, v in params.items()}
            xx = x.clone().requires_grad_()
            if sharded:
                with sh.use_mesh(mesh, sh.Rules.make()):
                    y, aux = mlp.moe_forward(ps, xx, cfg)
            else:
                y, aux = mlp.moe_forward(ps, xx, cfg)
            g = torch.autograd.grad((y ** 2).mean() + aux,
                                    list(ps.values()) + [xx])
            res[sharded] = {"y": y.detach().numpy(), "aux": float(aux),
                            "grads": dict(zip(list(ps) + ["x"],
                                              (t.numpy() for t in g)))}
        out[case] = res
    return out


# ---------------------------------------------------------------------------
# 8 ranks: the int8 pod sync and the compressed train step
# ---------------------------------------------------------------------------
def compress_ranks(rank, world, leaves_np: dict, n_steps: int):
    """On a (2 pod, 2 data, 2 model) mesh: ``_sync_leaf`` of this rank's
    pod's (grad, residual) pairs, plain and as DTensors on the pod's
    (data, model) sub-mesh with the last axis split over model; then
    ``n_steps`` plain and compressed train steps from one state on the
    same batches."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.models import common
    from repro_torch.sharding import specs as sh
    from repro_torch.train import compress as compress_lib
    from repro_torch.train import steps
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.schedule import ScheduleConfig

    mesh = _mesh((2, 2, 2))
    pod = mesh.get_coordinate()[0]
    group = mesh.get_group("pod")
    sub = mesh["data", "model"]
    out = {"pod": pod, "sync": {}, "sync_dtensor": {}}
    for name, (g, e) in leaves_np.items():
        g, e = (torch.from_numpy(np.array(t[pod])) for t in (g, e))
        got, err = compress_lib._sync_leaf(g, e, 2, group)
        out["sync"][name] = (got.numpy(), err.numpy())
        if g.dim() >= 2:  # the row split over model: absmax over the whole
            pl = (Replicate(), Shard(g.dim() - 1))
            gd = distribute_tensor(g, sub, pl, src_data_rank=None)
            ed = distribute_tensor(e, sub, pl, src_data_rank=None)
            got, err = compress_lib._sync_leaf(gd, ed, 2, group)
            out["sync_dtensor"][name] = (got.full_tensor().numpy(),
                                         err.full_tensor().numpy())

    cfg = get_config(ARCH).reduced(n_layers=2)
    ocfg, scfg = AdamWConfig(), ScheduleConfig(peak_lr=1e-3,
                                               warmup_steps=2)
    batches = [_tensors(step_batch(cfg.vocab, seed=i))
               for i in range(n_steps)]
    for compress in (False, True):
        step, _, ssh, bsh = steps.jit_train_step(
            cfg, ocfg, scfg, mesh, sh.Rules.make(), batches[0], BATCH_SPEC,
            compress=compress)
        state = sh.place(steps.init_train_state(
            common.make_generator(0, "cpu"), cfg, ocfg, compress=compress),
            ssh)
        losses = []
        for b in batches:
            state, m = step(state, sh.place(b, bsh))
            losses.append(float(m["loss"]))
        out["compressed" if compress else "plain"] = losses
    return out


# ---------------------------------------------------------------------------
# 4 or 8 ranks: a model axis of 4 that does not divide 2 KV heads (its 4
# query heads split one a rank), nor 6 heads and 6 KV heads (padded to 8)
# and a 250-word vocabulary (the loss's shares 63, 63, 63 and 61 words);
# the others' 256 words split 64 a rank (the embedding on each slice)
# ---------------------------------------------------------------------------
UNEVEN_ARCHS = {"starcoder2-3b": {},
                "qwen3-moe-235b-a22b": {"capacity_factor": 8.0},
                "mamba2-780m": {},
                "qwen1.5-32b": {"n_heads": 6, "n_kv_heads": 6, "vocab": 250},
                "whisper-small": {"n_heads": 6, "n_kv_heads": 6}}
DECODE_STEPS, DECODE_SEQ = 4, 8
ENC_FRAMES = 24  # an enc-dec's stub frames (up to whisper's 1,500)


def uneven_ranks(rank, world, mesh_shape):
    """For each UNEVEN_ARCHS config at ``reduced()`` on a (data, model)
    mesh of ``mesh_shape``: two train steps through ``jit_train_step``,
    prefill and DECODE_STEPS decode steps (``serve_step`` on caches of
    DECODE_SEQ positions, split along the sequence over ``model``) on
    DTensors placed by ``fitted_shardings`` under each shape's rules; on
    rank 0 the same on one device.  → per arch the losses, the params
    after the steps, the prefill logits and each decode step's logits and
    tokens, whole, and the query heads attention's core saw in the train
    steps and prefill (``core_heads``).  Also prefill's caches, whole,
    and the positions of each rank's share of its attention caches
    (``cache_seq``); an enc-dec decodes against its prefill's
    cross-attention caches, and the query heads its cached core saw in
    decode are ``cached_heads``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import rules_for_shape
    from repro_torch.configs import SHAPES
    from repro_torch.models import attention, common, model
    from repro_torch.sharding import specs as sh
    from repro_torch.train import steps
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.schedule import ScheduleConfig

    mesh = _mesh(mesh_shape)
    seen, cached = [], []
    for name, into in (("full_attention", seen), ("chunked_attention", seen),
                       ("_cached_attention", cached)):
        def watched(q, *a, _core=getattr(attention, name), _into=into, **k):
            _into.append(q.shape[2] * q.shape[3])  # (B, S, KV, rep, hd)
            return _core(q, *a, **k)
        setattr(attention, name, watched)
    out = {}
    for arch, over in UNEVEN_ARCHS.items():
        cfg = get_config(arch).reduced(**over)
        ocfg, scfg = AdamWConfig(), ScheduleConfig(peak_lr=1e-3,
                                                   warmup_steps=2)
        frames = (ENC_FRAMES, cfg.d_model) if cfg.is_encdec else None
        batch = _tensors(step_batch(cfg.vocab, frames=frames))
        bspec = dict(BATCH_SPEC, frames=("batch", None, "embed"))
        bspec = {k: bspec[k] for k in batch}
        b = batch["tokens"].shape[0]
        params, pspecs = model.init_model(common.make_generator(0, "cpu"),
                                          cfg)
        res = {}
        for sharded in (False, True):
            if not sharded and rank != 0:
                continue
            r = res[sharded] = {}
            seen.clear()
            # the train step
            state = steps.init_train_state(common.make_generator(0, "cpu"),
                                           cfg, ocfg)
            if sharded:
                step, _, ssh, bsh = steps.jit_train_step(
                    cfg, ocfg, scfg, mesh, sh.Rules.make(), batch, bspec)
                state, tb = sh.place(state, ssh), sh.place(batch, bsh)
            else:
                step = lambda s, bb: steps.train_step(s, bb, cfg, ocfg, scfg)
                tb = batch
            for _ in range(2):
                state, m = step(state, tb)
                r.setdefault("losses", []).append(float(sh.full(m["loss"])))
            r["params"] = _host(state["params"])
            # prefill, default rules
            prompt = {k: v for k, v in batch.items() if k != "labels"}
            p, rules = params, None
            if sharded:
                rules = rules_for_shape(SHAPES["prefill_32k"])
                p = sh.place(params, sh.fitted_shardings(params, pspecs, mesh,
                                                         rules))
                prompt = sh.place(prompt, sh.fitted_shardings(
                    prompt, {k: bspec[k] for k in prompt}, mesh, rules))
            with _on(mesh, rules):
                logits, pcaches = steps.serve_prefill(p, prompt, cfg)
            r["prefill"] = sh.full(logits).numpy()
            r["core_heads"] = sorted(set(seen))
            r["prefill_caches"] = _host(pcaches)
            r["cache_seq"] = _attention_cache_seq(pcaches)
            # decode over caches split along the sequence (an enc-dec's
            # cross-attention caches its prefill's)
            caches, cspecs = model.init_caches(cfg, b, DECODE_SEQ, "cpu")
            if cfg.is_encdec:
                for name in ("cross_k", "cross_v"):
                    caches[name] = sh.full(pcaches[name])
            del pcaches
            token = batch["tokens"][:, :1]
            cached.clear()
            if sharded:
                rules = rules_for_shape(SHAPES["decode_32k"])
                p = sh.place(params, sh.fitted_shardings(params, pspecs, mesh,
                                                         rules))
                caches = sh.place(caches, sh.fitted_shardings(
                    caches, cspecs, mesh, rules))
                tsh = sh.fitted_shardings({"t": token}, {"t": (
                    "batch", None)}, mesh, rules)
            for pos in range(DECODE_STEPS):
                t = sh.place({"t": token}, tsh)["t"] if sharded else token
                with _on(mesh, rules):
                    nxt, logits, caches = steps.serve_step(p, caches, t, pos,
                                                           cfg)
                r.setdefault("decode", []).append(sh.full(logits).numpy())
                token = sh.full(nxt)
                r.setdefault("tokens", []).append(token.numpy())
            r["caches"] = _host(caches)
            r["cached_heads"] = sorted(set(cached))
        out[arch] = res
    torch.distributed.barrier()
    return out


def _attention_cache_seq(caches) -> list:
    """The sequence positions of this rank's share of each attention
    cache (a ``k`` or ``v`` leaf, (n, B, KV, S, hd))."""
    from repro_torch.sharding import specs as sh

    out = []
    for name, t in caches.items():
        if isinstance(t, dict):
            out += _attention_cache_seq(t)
        elif name in ("k", "v"):
            out.append(sh.local(t).shape[3])
    return out


def embed_ranks(rank, world, vocab: int):
    """On a (1, 4) mesh: a ``(vocab, 32)`` table placed as ``tok_embed``
    (split along the vocab where 4 divides it, else whole) and looked up
    by ``common.embed_lookup``, against ``F.embedding`` of the whole
    table on the same ids, and the table's gradient under a seeded
    upstream gradient.  → (the whole lookup, its sharded counterpart
    gathered, the whole table's gradient, this rank's shard of the
    sharded gradient, the index of that shard's first row)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import common
    from repro_torch.sharding import specs as sh

    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((vocab, 32)).astype(
        np.float32))
    ids = torch.from_numpy(rng.integers(0, vocab, (8, 16)).astype(np.int32))
    ids[0, :4] = ids[0, 4]  # a row looked up more than once
    up = torch.from_numpy(rng.standard_normal((8, 16, 32)).astype(
        np.float32))
    whole = table.clone().requires_grad_()
    want = F.embedding(ids.long(), whole)
    (want * up).sum().backward()

    mesh, rules = _mesh((1, world)), sh.Rules.make()
    tree = {"table": table, "ids": ids}
    placed = sh.place(tree, sh.fitted_shardings(
        tree, {"table": ("vocab", "embed"), "ids": ("batch", None)}, mesh,
        rules), dtensor=True)
    t = placed["table"].requires_grad_()
    with sh.use_mesh(mesh, rules):
        got = common.embed_lookup(t, placed["ids"])
        (got * sh.as_dtensor(up, mesh)).sum().backward()
    start = sh.shard_start(t, 0)[0] if sh.spec_of(t)[0] else 0
    return (want.detach().numpy(), sh.full(got).detach().numpy(),
            whole.grad.numpy(), sh.local(t.grad).numpy(), start)


def _on(mesh, rules):
    """``use_mesh(mesh, rules)``, or nothing without rules."""
    import contextlib

    from repro_torch.sharding import specs as sh

    return contextlib.nullcontext() if rules is None else sh.use_mesh(
        mesh, rules)
