"""Single public entry point for every architecture.

``init_model / train_loss / prefill / init_caches / decode_step`` dispatch
on ``cfg.family`` so the launcher and tests never special-case
architectures.  Batches are plain dicts of tensors:

  train:   tokens (B,S) int, labels (B,S) int [+ patches (B,P,D) for vlm,
           frames (B,F,D) for audio]
  prefill: tokens (B,S) [+ patches / frames]
  decode:  token (B,1) int, pos int  [+ caches]

Params are nested dicts (lists for the layer stacks) of tensors on the
device their generator lives on.  Serving runs under ``torch.no_grad``;
``train_loss`` is differentiated by autograd (``train/steps.py``).
``params_from_jax`` / ``state_from_jax`` carry the reference's params or
train state across, and ``state_to_jax`` gives a state back in the
reference's stacked layout (what ``train/checkpoint.py`` writes).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, encdec, transformer
from repro_torch.sharding.specs import as_dtensor, replicate


def init_model(gen: torch.Generator, cfg: ModelConfig):
    """→ (params, logical-axis specs) for any family, drawn from ``gen``
    on its device (see ``common.make_generator``)."""
    if cfg.is_encdec:
        return encdec.init_encdec(gen, cfg)
    return transformer.init_decoder(gen, cfg)


def _forward(params, batch, cfg: ModelConfig, collect_cache: bool):
    if cfg.is_encdec:
        enc_out = encdec.encode(params, batch["frames"], cfg)
        logits, caches = encdec.decode_train(
            params, enc_out, batch["tokens"], cfg, collect_cache
        )
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    else:
        logits, aux, caches = transformer.decoder_forward(
            params, batch["tokens"], cfg, patches=batch.get("patches"),
            collect_cache=collect_cache,
        )
    return logits, aux, caches


def train_loss(params, batch, cfg: ModelConfig):
    """→ (scalar loss, metrics dict).  fp32 loss, z-loss regularized."""
    logits, aux, _ = _forward(params, batch, cfg, collect_cache=False)
    labels = batch["labels"]
    weights = batch.get("loss_weights")
    if weights is None and cfg.n_image_patches:
        # VLM: no next-token loss on image-patch positions
        s = labels.shape[1]
        weights = (torch.arange(s, device=labels.device)
                   >= cfg.n_image_patches).float().expand(labels.shape)
    loss, nll = common.softmax_cross_entropy(logits, labels, weights)
    # under a mesh the batch means are partial over its shards: reduced
    # here, and a plain aux joins them as a replicated DTensor
    loss, nll = replicate(loss), replicate(nll)
    total = loss + as_dtensor(aux, getattr(loss, "device_mesh", None))
    return total, {"loss": total, "nll": nll, "aux": aux}


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig):
    """Prefill pass: returns (last-position logits (B,V), caches)."""
    logits, _, caches = _forward(params, batch, cfg, collect_cache=True)
    return logits[:, -1], caches


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """Zeroed fixed-capacity decode caches on ``device`` (None: the GPU)."""
    if cfg.is_encdec:
        return encdec.init_encdec_caches(cfg, batch, max_seq, device)
    return transformer.init_decode_caches(cfg, batch, max_seq, device)


@torch.no_grad()
def decode_step(params, caches, token, pos: int, cfg: ModelConfig):
    """One-token decode: → (logits (B,V), caches updated in place)."""
    if cfg.is_encdec:
        return encdec.encdec_decode(params, caches, token, pos, cfg)
    return transformer.decoder_decode(params, caches, token, pos, cfg)


def leaves(tree):
    """The tensors of a params (or specs) tree, dict and list order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def param_count(params) -> int:
    return sum(int(x.numel()) for x in leaves(params))


def tree_map(fn, tree):
    """``fn`` of every leaf of a tree of dicts and lists, in its shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def to_device(tree, device):
    """A copy of a params (or caches) tree on ``device``."""
    return tree_map(lambda t: t.to(device), tree)


def model_flops_per_token(cfg: ModelConfig) -> float:
    """MODEL_FLOPS/token = 6·N (dense) or 6·N_active (MoE)."""
    d = cfg.d_model
    n_active = 2 * cfg.vocab * d  # embed + head
    if cfg.is_encdec:
        per_attn = 4 * d * cfg.n_heads * cfg.hd
        per_mlp = (3 if cfg.mlp_gated else 2) * d * cfg.d_ff
        n_active += cfg.n_layers * (2 * per_attn + per_mlp)
        n_active += cfg.encoder_layers * (per_attn + per_mlp)
        return 6.0 * n_active
    ng = transformer.n_groups(cfg)
    for spec in transformer.layer_program(cfg):
        if spec.mixer == "attn":
            n_active += ng * 2 * d * (cfg.n_heads + cfg.n_kv_heads) * cfg.hd
            n_active += ng * cfg.n_heads * cfg.hd * d  # wo
        else:
            din = cfg.d_inner
            conv_ch = din + 2 * cfg.ssm_groups * cfg.ssm_state
            n_active += ng * (
                d * (2 * din + 2 * cfg.ssm_groups * cfg.ssm_state
                     + cfg.ssm_heads)
                + cfg.ssm_conv * conv_ch
                + din * d
            )
        if spec.mlp == "dense":
            n_active += ng * (3 if cfg.mlp_gated else 2) * d * cfg.d_ff
        elif spec.mlp == "moe":
            n_active += ng * cfg.top_k * 3 * d * cfg.expert_ff
            n_active += ng * d * cfg.n_experts  # router
    return 6.0 * n_active


# ---------------------------------------------------------------------------
# weights carried across from the reference
# ---------------------------------------------------------------------------
def _unstack(tree, n: int) -> list:
    """A tree of stacked leaves (n, ...) → n trees of its slices."""
    return [tree_map(lambda a, g=g: a[g], tree) for g in range(n)]


def tensor_from_numpy(a, dev) -> torch.Tensor:
    """A numpy leaf as a tensor on ``dev``: bfloat16 (``ml_dtypes``, or
    the raw 2-byte ``V2`` words that ``np.save`` writes for it) becomes
    torch's bfloat16; every other dtype keeps its own."""
    a = np.asarray(a)
    if str(a.dtype) == "bfloat16":
        a = a.astype(np.float32)
        return torch.from_numpy(a).to(device=dev, dtype=torch.bfloat16)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        bits = torch.from_numpy(np.array(a).view(np.int16))
        return bits.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)  # a writable copy


def _stacks(cfg: ModelConfig) -> dict:
    """The reference's group-stacked subtrees and their leading axis."""
    if cfg.is_encdec:
        return {"encoder": cfg.encoder_layers, "decoder": cfg.n_layers}
    return {"layers": transformer.n_groups(cfg)}


@torch.no_grad()
def params_from_jax(np_params: dict, cfg: ModelConfig, device=None) -> dict:
    """The port's params from ``repro.models.model.init_model``'s, given as
    a tree of numpy arrays (``jax.tree.map(np.asarray, params)``).

    Group-stacked leaves (``layers``, ``encoder``, ``decoder``) are
    unstacked into the port's one-dict-a-layer lists.  Each leaf keeps the
    dtype the reference gave it: ``cfg.param_dtype``, and float32 for the
    router and the SSM's ``A_log``, ``D`` and ``dt_bias``.  Any tree with
    the params' top-level names works (an optimizer moment, whose int8
    leaves are ``{"q", "scale"}``, too).
    """
    dev = common.resolve_device(device)
    stacks = _stacks(cfg)
    leaf = lambda a: tensor_from_numpy(a, dev)
    out = {}
    for name, sub in np_params.items():
        if name in stacks:
            out[name] = tree_map(leaf, _unstack(sub, stacks[name]))
        else:
            out[name] = tree_map(leaf, sub)
    return out


def _has_quantized(tree) -> bool:
    if isinstance(tree, dict):
        return "q" in tree or any(_has_quantized(v) for v in tree.values())
    return isinstance(tree, list) and any(_has_quantized(v) for v in tree)


@torch.no_grad()
def state_from_jax(np_state: dict, cfg: ModelConfig, ocfg,
                   device=None) -> dict:
    """The port's train state from ``repro.train.steps``' one, given as a
    tree of numpy arrays: ``{"params", "opt": {"m", "v", "count"},
    "step"}``, fp32 or int8 (``{"q", "scale"}``) moments as ``ocfg``
    says, each tree unstacked as ``params_from_jax`` does."""
    dev = common.resolve_device(device)
    opt = np_state["opt"]
    if _has_quantized(opt["m"]) != ocfg.eight_bit:
        raise ValueError(f"moments do not match eight_bit={ocfg.eight_bit}")
    scalar = lambda a: torch.tensor(int(np.asarray(a)), dtype=torch.int32,
                                    device=dev)
    return {
        "params": params_from_jax(np_state["params"], cfg, dev),
        "opt": {"m": params_from_jax(opt["m"], cfg, dev),
                "v": params_from_jax(opt["v"], cfg, dev),
                "count": scalar(opt["count"])},
        "step": scalar(np_state["step"]),
    }


def _numpy_of(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)  # never a view of a live leaf
    if t.dtype == torch.bfloat16:  # numpy has no bfloat16: its raw words
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _stack_groups(groups: list):
    first = groups[0]
    if isinstance(first, dict):
        return {k: _stack_groups([g[k] for g in groups]) for k in first}
    return torch.stack([g.detach().to("cpu") for g in groups])


def state_to_jax(tree) -> dict:
    """A params or train-state tree as numpy arrays in the reference's
    layout: each list (a layer stack) stacked on a leading axis, on the
    host.  bfloat16 leaves come back as their raw ``V2`` words, as the
    reference's ``np.save`` writes them."""
    if isinstance(tree, dict):
        return {k: state_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return state_to_jax(_stack_groups(tree))
    return _numpy_of(tree)
