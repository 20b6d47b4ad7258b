"""Train and serve steps of the LM stack.

``train_step`` is a function of (state, batch), as the reference's; the
gradients come from autograd through ``model.train_loss`` (with remat,
``cfg.remat``), accumulated over ``cfg.microbatches`` in the reference's
order, then one AdamW step that updates the state's tensors in place.

State layout: ``{"params": ..., "opt": adamw state, "step": int32}``.
The reference's pod-compressed step (``make_compressed_train_step``) and
its sharding plumbing (``resolve_shardings``, ``jit_train_step``) need a
mesh, which the port does not have yet.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.schedule import ScheduleConfig, warmup_cosine


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------
def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     ocfg: AdamWConfig) -> dict:
    """Params drawn from ``gen`` on its device (``common.make_generator``:
    the GPU unless told otherwise), zeroed moments, step 0."""
    params, _ = model.init_model(gen, cfg)
    return {
        "params": params,
        "opt": opt_lib.adamw_init(params, ocfg),
        "step": torch.zeros((), dtype=torch.int32, device=gen.device),
    }


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the ``meta`` device: shapes and
    dtypes without storage."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def abstract_state(cfg: ModelConfig, ocfg: AdamWConfig):
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
    return shapes, specs


# ---------------------------------------------------------------------------
# gradients (with optional microbatch accumulation)
# ---------------------------------------------------------------------------
def split_microbatches(batch: dict, k: int) -> list[dict]:
    """``batch`` cut into ``k`` equal microbatches along dim 0."""
    b = next(iter(batch.values())).shape[0]
    if b % k:
        raise ValueError(f"batch {b} not divisible by microbatches {k}")
    return [{n: x[i * (b // k):(i + 1) * (b // k)] for n, x in batch.items()}
            for i in range(k)]


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
    return list(torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True))


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
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
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


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def serve_prefill(params, batch: dict, cfg: ModelConfig):
    return model.prefill(params, batch, cfg)


def serve_step(params, caches, token, pos: int, cfg: ModelConfig):
    """One decode step; greedy next token (the first maximum).
    → (next_token (B,1) int32, logits (B,V), caches updated in place)."""
    logits, caches = model.decode_step(params, caches, token, pos, cfg)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    return nxt, logits, caches
