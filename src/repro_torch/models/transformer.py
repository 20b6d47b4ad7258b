"""Unified decoder stack for all decoder-only architectures: dense GQA
(qwen/starcoder), VLM (llava — patch-embedding stub frontend), MoE
(qwen3-moe/grok), SSM (mamba2), and hybrid (jamba).

Layer heterogeneity (jamba's 1-attention-per-8 interleave, MoE on alternate
layers) is expressed as a *layer program*: the smallest repeating period of
slot specs, repeated ``n_groups`` times.  The reference stacks each slot's
leaves on a leading ``n_groups`` axis for one ``lax.scan``; the port keeps
one dict a group, ``params["layers"][g]["slot{j}"]``, and loops over the
groups.  Decode caches keep the reference's stacked layout (a leading
``n_groups`` axis a slot): prefill writes each group's into them as the
group ends (the reference's scan writes its stacked output directly),
and decode writes them in place.

With ``cfg.remat`` set and grad mode on, each layer group's body runs
under ``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
reference's ``jax.checkpoint`` of its scan body: the backward recomputes a
group's activations (and its weights' compute-dtype casts) instead of
keeping them.  ``cfg.scan_unroll``, a lowering switch, is ignored.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, mlp, ssm
from repro_torch.models.common import dense_init, split_tree
from repro_torch.sharding import specs as sh
from repro_torch.sharding.specs import logical_constraint as wsc
from repro_torch.sharding.specs import recompute_context, replicate


@dataclasses.dataclass(frozen=True)
class SlotSpec:
    mixer: str  # "attn" | "mamba"
    mlp: str  # "dense" | "moe" | "none"


def layer_program(cfg: ModelConfig) -> tuple[SlotSpec, ...]:
    """The smallest repeating period of layer kinds."""
    period = 1
    if cfg.attn_every:
        period = cfg.attn_every
    if cfg.n_experts:
        period = period * cfg.moe_every // math.gcd(period, cfg.moe_every)
    slots = []
    for i in range(period):
        mixer = "attn" if cfg.is_attn_layer(i) else "mamba"
        if cfg.family == "ssm":
            m = "none"  # mamba2 blocks are mixer-only
        elif cfg.is_moe_layer(i):
            m = "moe"
        else:
            m = "dense"
        slots.append(SlotSpec(mixer, m))
    return tuple(slots)


def n_groups(cfg: ModelConfig) -> int:
    period = len(layer_program(cfg))
    if cfg.n_layers % period:
        raise ValueError(
            f"{cfg.name}: n_layers={cfg.n_layers} not divisible by "
            f"layer-program period {period}"
        )
    return cfg.n_layers // period


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def init_norm(cfg: ModelConfig, device=None):
    dt = common.pdtype(cfg)
    ones = torch.ones((cfg.d_model,), dtype=dt, device=device)
    if cfg.norm_type == "layernorm":
        p = {"scale": ones,
             "bias": torch.zeros((cfg.d_model,), dtype=dt, device=device)}
        s = {"scale": ("embed",), "bias": ("embed",)}
    else:
        p = {"scale": ones}
        s = {"scale": ("embed",)}
    return p, s


def apply_norm(p, x, cfg: ModelConfig):
    if cfg.norm_type == "layernorm":
        return common.layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    return common.rmsnorm(x, p["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# slot init / forward
# ---------------------------------------------------------------------------
def init_slot(gen, spec: SlotSpec, cfg: ModelConfig):
    p, s = {}, {}
    p["ln1"], s["ln1"] = init_norm(cfg, gen.device)
    if spec.mixer == "attn":
        p["mix"], s["mix"] = attention.init_attention(gen, cfg)
    else:
        p["mix"], s["mix"] = ssm.init_mamba(gen, cfg)
    if spec.mlp != "none":
        p["ln2"], s["ln2"] = init_norm(cfg, gen.device)
        if spec.mlp == "moe":
            p["mlp"], s["mlp"] = mlp.init_moe(gen, cfg)
        else:
            p["mlp"], s["mlp"] = mlp.init_mlp(gen, cfg)
    return p, s


def init_layer_stack(gen, cfg: ModelConfig):
    """All layers: a list of ``n_groups`` dicts ``{"slot{j}": params}``,
    and the specs, one dict a group as well."""
    program = layer_program(cfg)
    params, specs = [], []
    for _ in range(n_groups(cfg)):
        group, gspec = {}, {}
        for j, spec in enumerate(program):
            group[f"slot{j}"], gspec[f"slot{j}"] = init_slot(gen, spec, cfg)
        params.append(group)
        specs.append(gspec)
    return params, specs


def whole_seq(h):
    """A block's normed input or its output, whole over the sequence: on
    a mesh the sequence-parallel residual's all-gather before a block and
    the reduction of its partial sums after it, so that no matmul (nor
    its backward) sees a sequence split beside a batch split, for which
    DTensor has no cheap plan."""
    return wsc(h, ("batch", "seq", "embed"))


def apply_slot(p, spec: SlotSpec, x, positions, cfg: ModelConfig,
               collect_cache: bool = False):
    """One residual block.  Returns (x, aux_loss, cache_or_None).

    Under a mesh the residual stream is sequence-sharded (``seq_sp``);
    each block's input and output are whole over the sequence
    (``whole_seq``), as the reference's partitioner makes them."""
    h = whole_seq(apply_norm(p["ln1"], x, cfg))
    cache = None
    if spec.mixer == "attn":
        if collect_cache:
            y, (k, v) = attention.attn_forward(
                p["mix"], h, positions, cfg, causal=True, return_kv=True
            )
            cache = {"k": k, "v": v}
        else:
            y = attention.attn_forward(
                p["mix"], h, positions, cfg, causal=True
            )
    else:
        y, final_state, conv_tail = ssm.mamba_forward(p["mix"], h, cfg)
        if collect_cache:
            cache = {"state": final_state, "conv": conv_tail}
    x = x + whole_seq(y)
    x = wsc(x, ("batch", "seq_sp", "embed"))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.mlp != "none":
        h = whole_seq(apply_norm(p["ln2"], x, cfg))
        if spec.mlp == "moe":
            y, aux = mlp.moe_forward(p["mlp"], h, cfg)
        else:
            y = mlp.mlp_forward(p["mlp"], h, cfg)
        x = x + whole_seq(y)
        x = wsc(x, ("batch", "seq_sp", "embed"))
    return x, aux, cache


def _stacked_like(t, n: int):
    """An empty (n, *t.shape) tensor, laid out as ``t`` along its last
    dims (a DTensor's leading dim whole)."""
    if not isinstance(t, sh.DTensor):
        return t.new_empty((n,) + tuple(t.shape))
    shard = sh.local(t)
    return sh.from_local(shard.new_empty((n,) + tuple(shard.shape)),
                         sh.P(None, *sh.spec_of(t)), t.device_mesh)


def _stack_into(stacked, i: int, caches) -> None:
    """Group ``i``'s caches written into their slot of the stacked ones
    (as ``torch.stack`` of every group's would give, without holding
    every group's caches and their stack at once)."""
    for slot, c in caches.items():
        for name, t in c.items():
            buf = stacked[slot][name]
            if isinstance(buf, sh.DTensor):
                t = sh.as_dtensor(t, buf.device_mesh).redistribute(
                    buf.device_mesh, sh.placements(
                        sh.P(*sh.spec_of(buf)[1:]), buf.device_mesh))
            sh.local(buf)[i].copy_(sh.local(t))


def stack_forward(layers, x, positions, cfg: ModelConfig,
                  collect_cache: bool = False):
    """The layer groups in turn.  Returns (x, aux_sum, caches|None).

    ``caches`` (when collected) is {slotJ: tree with leading n_groups}.
    """
    program = layer_program(cfg)

    def body(lp, x, aux):
        caches = {}
        for j, spec in enumerate(program):
            x, a, cache = apply_slot(
                lp[f"slot{j}"], spec, x, positions, cfg, collect_cache
            )
            aux = aux + a
            caches[f"slot{j}"] = cache
        return x, aux, caches

    remat = cfg.remat and torch.is_grad_enabled() and not collect_cache
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    stacked = None
    for i, lp in enumerate(layers):
        if remat:
            x, aux = checkpoint(lambda *a: body(*a)[:2], lp, x, aux,
                                use_reentrant=False,
                                context_fn=recompute_context)
        else:
            x, aux, caches = body(lp, x, aux)
            if collect_cache:
                if stacked is None:
                    stacked = {slot: {name: _stacked_like(t, len(layers))
                                      for name, t in c.items()}
                               for slot, c in caches.items()}
                _stack_into(stacked, i, caches)
            del caches
    return x, aux, stacked


# ---------------------------------------------------------------------------
# full decoder model
# ---------------------------------------------------------------------------
def init_decoder(gen, cfg: ModelConfig):
    dt = common.pdtype(cfg)
    pairs = {
        "tok_embed": dense_init(
            gen, (cfg.vocab, cfg.d_model), dt, ("vocab", "embed"), scale=1.0
        ),
        "head": dense_init(
            gen, (cfg.d_model, cfg.vocab), dt, ("embed", "vocab")
        ),
    }
    if cfg.pos_embed == "learned":
        maxp = cfg.max_positions or 4096
        pairs["pos_embed"] = dense_init(
            gen, (maxp, cfg.d_model), dt, (None, "embed"), scale=0.02
        )
    if cfg.n_image_patches:
        # VLM adapter: the anyres frontend is a stub (the batch supplies
        # projected patch embeddings); mm_proj is the trainable projector.
        pairs["mm_proj"] = dense_init(
            gen, (cfg.d_model, cfg.d_model), dt, ("fsdp", None)
        )
    params, specs = split_tree(pairs)
    params["final_ln"], specs["final_ln"] = init_norm(cfg, gen.device)
    params["layers"], specs["layers"] = init_layer_stack(gen, cfg)
    return params, specs


def embed_tokens(params, tokens, positions, cfg: ModelConfig):
    ct = common.cdtype(cfg)
    x = common.embed_lookup(params["tok_embed"], tokens).to(ct)
    if cfg.pos_embed == "learned":
        x = x + F.embedding(positions.long(),
                            replicate(params["pos_embed"])).to(ct)
    return x


def merge_patches(params, x, patches, cfg: ModelConfig):
    """VLM: image patch embeddings occupy the first n_patches positions."""
    ct = common.cdtype(cfg)
    proj = patches.to(ct) @ params["mm_proj"].to(ct)
    npat = cfg.n_image_patches
    s = x.shape[1]
    if npat >= s:
        raise ValueError("sequence shorter than patch count")
    pad = F.pad(proj, (0, 0, 0, s - npat))
    is_img = (torch.arange(s, device=x.device) < npat)[None, :, None]
    return torch.where(is_img, pad, x)


def head_logits(params, x, cfg: ModelConfig, norm: str = "final_ln"):
    """Final norm, then the vocab projection in the compute dtype."""
    x = whole_seq(apply_norm(params[norm], x, cfg))
    ct = common.cdtype(cfg)
    return x.to(ct) @ params["head"].to(ct)


def decoder_forward(params, tokens, cfg: ModelConfig, patches=None,
                    collect_cache: bool = False):
    """tokens (B,S) → (logits (B,S,V), aux_loss, caches|None)."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    x = embed_tokens(params, tokens, positions, cfg)
    if cfg.n_image_patches and patches is not None:
        x = merge_patches(params, x, patches, cfg)
    x = wsc(x, ("batch", "seq_sp", "embed"))
    x, aux, caches = stack_forward(
        params["layers"], x, positions, cfg, collect_cache
    )
    logits = wsc(head_logits(params, x, cfg), ("batch", None, "vocab"))
    return logits, aux, caches


# ---------------------------------------------------------------------------
# decode (one token against caches)
# ---------------------------------------------------------------------------
def init_decode_caches(cfg: ModelConfig, batch: int, max_seq: int,
                       device=None):
    """Stacked per-slot caches + logical specs (leading n_groups axis)."""
    program = layer_program(cfg)
    ng = n_groups(cfg)
    dev = common.resolve_device(device)
    caches, specs = {}, {}
    for j, spec in enumerate(program):
        if spec.mixer == "attn":
            caches[f"slot{j}"], specs[f"slot{j}"] = attention.init_kv_cache(
                cfg, batch, max_seq, ng, dev)
        else:
            caches[f"slot{j}"], specs[f"slot{j}"] = ssm.init_mamba_cache(
                cfg, batch, ng, dev)
    return caches, specs


def decoder_decode(params, caches, token, pos: int, cfg: ModelConfig):
    """One decode step.  token (B,1) int, pos int (current index).

    Updates ``caches`` in place; returns (logits (B,V), caches).
    """
    program = layer_program(cfg)
    b = token.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32,
                           device=token.device)
    x = embed_tokens(params, token, positions, cfg)
    for g, lp in enumerate(params["layers"]):
        for j, spec in enumerate(program):
            p, c = lp[f"slot{j}"], caches[f"slot{j}"]
            h = apply_norm(p["ln1"], x, cfg)
            if spec.mixer == "attn":
                y, _, _ = attention.attn_decode(
                    p["mix"], h, c["k"][g], c["v"][g], pos, cfg)
            else:
                y, _, _ = ssm.mamba_decode(
                    p["mix"], h, c["state"][g], c["conv"][g], cfg)
            x = x + y
            if spec.mlp != "none":
                h = apply_norm(p["ln2"], x, cfg)
                if spec.mlp == "moe":
                    y, _ = mlp.moe_forward(p["mlp"], h, cfg)
                else:
                    y = mlp.mlp_forward(p["mlp"], h, cfg)
                x = x + y
    logits = wsc(head_logits(params, x, cfg)[:, 0], ("batch", "vocab"))
    return logits, caches
