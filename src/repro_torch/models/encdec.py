"""Whisper-style encoder-decoder (audio family).

The conv/mel frontend is a STUB: the batch supplies precomputed frame
embeddings (B, n_frames, d_model); the encoder adds learned positions and
runs bidirectional self-attention layers.  The decoder is a causal stack
with cross-attention to the encoder output.  Each stack is a list of
per-layer dicts (the reference stacks them for ``lax.scan``); the decode
caches keep the reference's stacked layout and are written in place.
With ``cfg.remat`` set and grad mode on, each layer runs under
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` of its
scan bodies.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, mlp
from repro_torch.models.common import dense_init, split_tree
from repro_torch.models.transformer import (apply_norm, head_logits,
                                            init_norm, whole_seq)
from repro_torch.sharding.specs import logical_constraint as wsc
from repro_torch.sharding.specs import recompute_context, replicate

N_FRAMES = 1500  # whisper's 30 s @ 50 Hz after the conv frontend


def _stack_init(one_layer_fn, n_layers: int):
    pairs = [one_layer_fn() for _ in range(n_layers)]
    return [p for p, _ in pairs], [s for _, s in pairs]


def _init_enc_layer(gen, cfg: ModelConfig):
    p, s = {}, {}
    p["ln1"], s["ln1"] = init_norm(cfg, gen.device)
    p["attn"], s["attn"] = attention.init_attention(gen, cfg)
    p["ln2"], s["ln2"] = init_norm(cfg, gen.device)
    p["mlp"], s["mlp"] = mlp.init_mlp(gen, cfg)
    return p, s


def _init_dec_layer(gen, cfg: ModelConfig):
    p, s = {}, {}
    p["ln1"], s["ln1"] = init_norm(cfg, gen.device)
    p["self"], s["self"] = attention.init_attention(gen, cfg)
    p["ln_x"], s["ln_x"] = init_norm(cfg, gen.device)
    p["cross"], s["cross"] = attention.init_attention(gen, cfg)
    p["ln2"], s["ln2"] = init_norm(cfg, gen.device)
    p["mlp"], s["mlp"] = mlp.init_mlp(gen, cfg)
    return p, s


def init_encdec(gen, cfg: ModelConfig):
    dt = common.pdtype(cfg)
    maxp = cfg.max_positions or 4096
    pairs = {
        "enc_pos": dense_init(
            gen, (N_FRAMES, cfg.d_model), dt, (None, "embed"), scale=0.02
        ),
        "tok_embed": dense_init(
            gen, (cfg.vocab, cfg.d_model), dt, ("vocab", "embed"), scale=1.0
        ),
        "dec_pos": dense_init(
            gen, (maxp, cfg.d_model), dt, (None, "embed"), scale=0.02
        ),
        "head": dense_init(
            gen, (cfg.d_model, cfg.vocab), dt, ("embed", "vocab")
        ),
    }
    params, specs = split_tree(pairs)
    params["enc_ln"], specs["enc_ln"] = init_norm(cfg, gen.device)
    params["dec_ln"], specs["dec_ln"] = init_norm(cfg, gen.device)
    params["encoder"], specs["encoder"] = _stack_init(
        lambda: _init_enc_layer(gen, cfg), cfg.encoder_layers
    )
    params["decoder"], specs["decoder"] = _stack_init(
        lambda: _init_dec_layer(gen, cfg), cfg.n_layers
    )
    return params, specs


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _remat(cfg: ModelConfig) -> bool:
    return cfg.remat and torch.is_grad_enabled()


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------
def encode(params, frames, cfg: ModelConfig):
    """frames (B, F, D) stub embeddings → (B, F, D) encoder states."""
    ct = common.cdtype(cfg)
    b, f, _ = frames.shape
    positions = _positions(b, f, frames.device)
    x = frames.to(ct) + params["enc_pos"][None, :f].to(ct)
    x = wsc(x, ("batch", "seq_sp", "embed"))

    def body(lp, x):
        h = whole_seq(apply_norm(lp["ln1"], x, cfg))
        x = x + whole_seq(attention.attn_forward(
            lp["attn"], h, positions, cfg, causal=False
        ))
        h = whole_seq(apply_norm(lp["ln2"], x, cfg))
        x = x + whole_seq(mlp.mlp_forward(lp["mlp"], h, cfg))
        return wsc(x, ("batch", "seq_sp", "embed"))

    for lp in params["encoder"]:
        x = (checkpoint(body, lp, x, use_reentrant=False,
                        context_fn=recompute_context) if _remat(cfg)
             else body(lp, x))
    # whole over the frames: the cross-attention's K/V input
    return whole_seq(apply_norm(params["enc_ln"], x, cfg))


# ---------------------------------------------------------------------------
# decoder (teacher-forced / prefill)
# ---------------------------------------------------------------------------
def _embed(params, tokens, positions, cfg: ModelConfig):
    ct = common.cdtype(cfg)
    x = common.embed_lookup(params["tok_embed"], tokens).to(ct)
    return x + F.embedding(positions.long(),
                           replicate(params["dec_pos"])).to(ct)


def decode_train(params, enc_out, tokens, cfg: ModelConfig,
                 collect_cache: bool = False):
    """Teacher-forced decoder pass.  Returns (logits, caches|None); the
    caches are stacked (n_layers, ...) as the reference's scan emits
    them."""
    b, s = tokens.shape
    f = enc_out.shape[1]
    positions = _positions(b, s, tokens.device)
    enc_positions = _positions(b, f, tokens.device)
    x = _embed(params, tokens, positions, cfg)
    x = wsc(x, ("batch", "seq_sp", "embed"))

    def body(lp, x):
        h = whole_seq(apply_norm(lp["ln1"], x, cfg))
        y, (k, v) = attention.attn_forward(
            lp["self"], h, positions, cfg, causal=True, return_kv=True
        )
        x = x + whole_seq(y)
        h = whole_seq(apply_norm(lp["ln_x"], x, cfg))
        y, (ck, cv) = attention.attn_forward(
            lp["cross"], h, positions, cfg, causal=False,
            kv_x=enc_out, kv_positions=enc_positions, return_kv=True,
        )
        x = x + whole_seq(y)
        h = whole_seq(apply_norm(lp["ln2"], x, cfg))
        x = x + whole_seq(mlp.mlp_forward(lp["mlp"], h, cfg))
        x = wsc(x, ("batch", "seq_sp", "embed"))
        return x, {"k": k, "v": v, "cross_k": ck, "cross_v": cv}

    remat = _remat(cfg) and not collect_cache
    per_layer = []
    for lp in params["decoder"]:
        if remat:
            x = checkpoint(lambda *a: body(*a)[0], lp, x,
                           use_reentrant=False,
                           context_fn=recompute_context)
        else:
            x, cache = body(lp, x)
            if collect_cache:
                per_layer.append(cache)
    caches = None
    if collect_cache:
        caches = {name: torch.stack([c[name] for c in per_layer])
                  for name in per_layer[0]}
    logits = wsc(head_logits(params, x, cfg, norm="dec_ln"),
                 ("batch", None, "vocab"))
    return logits, caches


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------
def init_encdec_caches(cfg: ModelConfig, batch: int, max_seq: int,
                       device=None):
    ct = common.cdtype(cfg)
    dev = common.resolve_device(device)
    nl = cfg.n_layers
    self_shape = (nl, batch, cfg.n_kv_heads, max_seq, cfg.hd)
    cross_shape = (nl, batch, cfg.n_kv_heads, N_FRAMES, cfg.hd)
    self_axes = ("layers", "batch", "kv_heads", "cache_seq", None)
    cross_axes = ("layers", "batch", "kv_heads", None, None)
    caches = {
        "k": torch.zeros(self_shape, dtype=ct, device=dev),
        "v": torch.zeros(self_shape, dtype=ct, device=dev),
        "cross_k": torch.zeros(cross_shape, dtype=ct, device=dev),
        "cross_v": torch.zeros(cross_shape, dtype=ct, device=dev),
    }
    specs = {
        "k": self_axes, "v": self_axes,
        "cross_k": cross_axes, "cross_v": cross_axes,
    }
    return caches, specs


def encdec_decode(params, caches, token, pos: int, cfg: ModelConfig):
    """One decode step against self + cross caches; the self caches are
    written in place.  Returns (logits (B,V), caches)."""
    b = token.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32,
                           device=token.device)
    x = _embed(params, token, positions, cfg)
    for i, lp in enumerate(params["decoder"]):
        h = apply_norm(lp["ln1"], x, cfg)
        y, _, _ = attention.attn_decode(
            lp["self"], h, caches["k"][i], caches["v"][i], pos, cfg
        )
        x = x + y
        h = apply_norm(lp["ln_x"], x, cfg)
        x = x + attention.cross_attn_cached(
            lp["cross"], h, caches["cross_k"][i], caches["cross_v"][i], cfg
        )
        h = apply_norm(lp["ln2"], x, cfg)
        x = x + mlp.mlp_forward(lp["mlp"], h, cfg)
    logits = wsc(head_logits(params, x, cfg, norm="dec_ln")[:, 0],
                 ("batch", "vocab"))
    return logits, caches
