"""Train and serve steps of the LM stack.

``train_step`` is a function of (state, batch), as the reference's; the
gradients come from autograd through ``model.train_loss`` (with remat,
``cfg.remat``), accumulated over ``cfg.microbatches`` in the reference's
order, then one AdamW step that updates the state's tensors in place.

Variants, as the reference's: int8 error-feedback cross-pod gradient
sync (``compress=True``, ``make_compressed_train_step``): the step body
runs as a region where ``pod`` is manual, on each pod's own batch rows,
and ``data``/``model`` stay automatic (DTensors on the pod's sub-mesh).

``jit_train_step`` is the sharding plumbing: the state's leaves are
DTensors placed by ``fitted_shardings`` over the spec tree, and the step
runs under ``use_mesh``.  It compiles nothing (the name is the
reference's).  On a mesh of one device the leaves stay plain tensors:
every placement there is a whole tensor.

State layout: ``{"params": ..., "opt": adamw state, "step": int32
[, "err": residuals]}``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model
from repro_torch.sharding import specs as sh
from repro_torch.train import compress as compress_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.schedule import ScheduleConfig, warmup_cosine


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------
def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     ocfg: AdamWConfig, compress: bool = False) -> dict:
    """Params drawn from ``gen`` on its device (``common.make_generator``:
    the GPU unless told otherwise), zeroed moments, step 0 (and zeroed
    error-feedback residuals with ``compress``).  Every rank that draws
    from the same seed holds the same full state."""
    params, _ = model.init_model(gen, cfg)
    state = {
        "params": params,
        "opt": opt_lib.adamw_init(params, ocfg),
        "step": torch.zeros((), dtype=torch.int32, device=gen.device),
    }
    if compress:
        state["err"] = compress_lib.init_error_state(params)
    return state


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the ``meta`` device: shapes and
    dtypes without storage."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def abstract_state(cfg: ModelConfig, ocfg: AdamWConfig,
                   compress: bool = False):
    """(state tree of ``meta`` tensors, logical-axis spec tree): the
    shapes and dtypes of ``init_train_state``'s state, allocating
    nothing."""
    params, p_specs = model.init_model(_MetaGenerator(), cfg)
    shapes = {
        "params": params,
        "opt": opt_lib.adamw_init(params, ocfg),
        "step": torch.zeros((), dtype=torch.int32, device="meta"),
    }
    specs = {
        "params": p_specs,
        "opt": opt_lib.opt_state_specs(p_specs, ocfg),
        "step": (),
    }
    if compress:
        shapes["err"] = compress_lib.init_error_state(params)
        specs["err"] = p_specs
    return shapes, specs


# ---------------------------------------------------------------------------
# gradients (with optional microbatch accumulation)
# ---------------------------------------------------------------------------
def split_microbatches(batch: dict, k: int) -> list[dict]:
    """``batch`` cut into ``k`` equal microbatches along dim 0, each laid
    out as the batch is (a DTensor's slice along a split dim comes back
    whole on every rank)."""
    b = next(iter(batch.values())).shape[0]
    if b % k:
        raise ValueError(f"batch {b} not divisible by microbatches {k}")

    def cut(x, i):
        mb = x[i * (b // k):(i + 1) * (b // k)]
        if isinstance(x, DTensor) and mb.placements != x.placements:
            mb = mb.redistribute(x.device_mesh, x.placements)
        return mb

    return [{n: cut(x, i) for n, x in batch.items()} for i in range(k)]


def microbatch_loss(params, batch: dict, cfg: ModelConfig):
    """The forward half of ``loss_and_grads``: → (loss with its graph,
    detached metrics, the leaves it is differentiated by)."""
    live = [p.detach().requires_grad_() for p in model.leaves(params)]
    it = iter(live)
    tree = model.tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss, metrics = model.train_loss(tree, batch, cfg)
    return loss, {k: v.detach() for k, v in metrics.items()}, live


def microbatch_grads(loss: torch.Tensor, live: list) -> list:
    """The backward half: d loss / d each leaf (zeros for a leaf the batch
    does not reach, as ``jax.grad`` gives)."""
    return [_one_level(g) for g in torch.autograd.grad(
        loss, live, allow_unused=True, materialize_grads=True)]


def _one_level(g: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient as one DTensor over plain shards: torch 2.11
    returns some of them as a DTensor whose shard is a DTensor again,
    which its in-place ops refuse."""
    while isinstance(g, DTensor) and isinstance(g.to_local(), DTensor):
        g = g.to_local()
    return g


def loss_and_grads(params, batch: dict, cfg: ModelConfig):
    """→ (flat grads in ``model.leaves`` order, metrics): ``train_loss``
    differentiated by autograd with respect to every leaf."""
    loss, metrics, live = microbatch_loss(params, batch, cfg)
    return microbatch_grads(loss, live), metrics


def _grads_and_metrics(params, batch: dict, cfg: ModelConfig):
    k = max(cfg.microbatches, 1)
    if k == 1:
        grads, metrics = loss_and_grads(params, batch, cfg)
    else:
        # laid out as the params (DTensors under a mesh)
        grads = [torch.zeros_like(p, dtype=torch.float32)
                 for p in model.leaves(params)]
        per_mb = []
        for mb in split_microbatches(batch, k):
            g_mb, metrics = loss_and_grads(params, mb, cfg)
            for acc, g in zip(grads, g_mb):
                acc.add_(g.to(torch.float32) / k)
            del g_mb
            per_mb.append(metrics)
        metrics = {n: torch.stack([m[n] for m in per_mb]).mean()
                   for n in per_mb[0]}
    it = iter(grads)
    return model.tree_map(lambda _: next(it), params), metrics


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
def train_step(state: dict, batch: dict, cfg: ModelConfig,
               ocfg: AdamWConfig, scfg: ScheduleConfig):
    """One step → (state, metrics with ``grad_norm`` and ``lr``).  The
    state's params and moments are updated in place."""
    grads, metrics = _grads_and_metrics(state["params"], batch, cfg)
    lr = warmup_cosine(state["step"], scfg)
    params, opt, gnorm = opt_lib.adamw_update(
        state["params"], grads, state["opt"], lr, ocfg
    )
    del grads
    metrics = dict(metrics, grad_norm=gnorm, lr=lr)
    return {"params": params, "opt": opt, "step": state["step"] + 1}, metrics


def _on_submesh(x, sub, drop: int):
    """A DTensor on the full mesh as one on ``sub`` (the full mesh without
    its dim ``drop``), holding this rank's same local shard; a plain
    tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    pl = tuple(x.placements)
    shape = list(x.shape)
    if pl[drop].is_shard():  # the manual dim's rows: this pod's alone
        shape[pl[drop].dim] //= x.device_mesh.shape[drop]
    return DTensor.from_local(
        x.to_local(), sub, pl[:drop] + pl[drop + 1:], run_check=False,
        shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def make_compressed_train_step(cfg: ModelConfig, ocfg: AdamWConfig,
                               scfg: ScheduleConfig, mesh):
    """Train step with the pod axis manual + int8 grad sync (compress.py).

    The batch arrives sharded over ('pod', 'data') on dim 0; inside the
    region each pod computes grads on its own rows as DTensors on the
    (data, model) sub-mesh, then syncs them over ``pod``.  The params and
    moments are replicated over pod and updated in place; each pod keeps
    its own residual in ``err`` (the same placement, pod-local values:
    that is error feedback).
    """
    sync, _, n_pods = compress_lib.make_pod_sync(mesh)
    names = tuple(mesh.mesh_dim_names)
    drop = names.index("pod")
    sub = mesh[tuple(a for a in names if a != "pod")]
    pod_group = mesh.get_group("pod")
    on_sub = lambda t: model.tree_map(lambda x: _on_submesh(x, sub, drop), t)

    def step(state, batch):
        st = {k: on_sub(v) for k, v in state.items()}
        grads, metrics = _grads_and_metrics(st["params"], on_sub(batch), cfg)
        grads, err = sync(grads, st["err"])
        lr = warmup_cosine(st["step"], scfg)
        # params and moments are updated in place: the sub-mesh DTensors
        # share their shards with the state's
        _, opt, gnorm = opt_lib.adamw_update(
            st["params"], grads, st["opt"], lr, ocfg)
        del grads
        for old, new in zip(model.leaves(st["err"]), model.leaves(err)):
            sh.assign(old, new)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        metrics = {k: _pod_mean(v, pod_group, n_pods)
                   for k, v in metrics.items()}
        new_opt = dict(state["opt"], count=opt["count"])
        return dict(state, opt=new_opt, step=state["step"] + 1), metrics

    return step


def _pod_mean(v, group, n: int) -> torch.Tensor:
    v = torch.as_tensor(sh.local(sh.replicate(v))).to(torch.float32).clone()
    dist.all_reduce(v, group=group)
    return v / n


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _on_mesh():
    """Under an active mesh, plain tensors (positions, masks, a batch's
    tokens) join DTensors as replicated; else nothing."""
    if sh.active_mesh() is None:
        return contextlib.nullcontext()
    return implicit_replication()


def serve_prefill(params, batch: dict, cfg: ModelConfig):
    """The prompt's forward pass: → (last-position logits (B,V), caches).
    Under ``use_mesh`` the params may be DTensors (``fitted_shardings``)."""
    with _on_mesh():
        return model.prefill(params, batch, cfg)


def serve_step(params, caches, token, pos: int, cfg: ModelConfig):
    """One decode step; greedy next token (the first maximum).
    → (next_token (B,1) int32, logits (B,V), caches updated in place).
    Under ``use_mesh`` the params and caches may be DTensors; a cache
    split along its sequence is written only by the rank that holds
    ``pos``."""
    with _on_mesh():
        logits, caches = model.decode_step(params, caches, token, pos, cfg)
        nxt = torch.argmax(sh.batch_only(logits), dim=-1).to(
            torch.int32)[:, None]
    return nxt, logits, caches


# ---------------------------------------------------------------------------
# sharding plumbing
# ---------------------------------------------------------------------------
def resolve_shardings(spec_tree, mesh, rules):
    return sh.tree_shardings(spec_tree, mesh, rules)


def _plain_metrics(metrics: dict) -> dict:
    return {k: sh.local(sh.replicate(v)) for k, v in metrics.items()}


def jit_train_step(cfg, ocfg, scfg, mesh, rules, batch_shapes, batch_specs,
                   compress: bool = False):
    """→ (step, state_shapes, state_shardings, batch_shardings).

    ``state_shapes`` is ``abstract_state``'s (``meta`` tensors); the two
    sharding trees are NamedShardings fitted to the shapes
    (``specs.place`` lays a full state or batch out by them).
    ``step(state, batch)`` runs the train step under ``use_mesh``
    (``rules`` without ``pod`` when compressing, where pod is manual) and
    returns (state, metrics), the metrics as plain tensors.  Nothing is
    compiled: the name is the reference's.
    """
    state_shapes, state_specs = abstract_state(cfg, ocfg, compress)
    state_sh = sh.fitted_shardings(state_shapes, state_specs, mesh, rules)
    batch_sh = sh.fitted_shardings(batch_shapes, batch_specs, mesh, rules)
    if compress:
        fn = make_compressed_train_step(cfg, ocfg, scfg, mesh)
    else:
        fn = lambda s, b: train_step(s, b, cfg, ocfg, scfg)
    # inside the pod-manual region: the (data, model) sub-mesh, and
    # constraints that do not mention pod
    run_mesh, run_rules = mesh, rules
    if compress:
        run_mesh = mesh[tuple(a for a in mesh.mesh_dim_names if a != "pod")]
        run_rules = rules.without_axis("pod")

    def step(state, batch):
        with sh.use_mesh(run_mesh, run_rules), implicit_replication():
            state, metrics = fn(state, batch)
        return state, _plain_metrics(metrics)

    return step, state_shapes, state_sh, batch_sh
