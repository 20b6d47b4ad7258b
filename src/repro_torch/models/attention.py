"""GQA attention: full, KV-chunked (online-softmax), and decode-with-cache.

Anything longer than twice ``cfg.attn_chunk`` runs the chunked path: a
double loop over (query-chunks × kv-chunks) carrying an f32 running max,
denominator and accumulator, the reference's ``lax.scan`` form in plain
torch ops, so the summation order and the masking follow it.  Score
products take their operands in f32 (the reference's
``preferred_element_type=float32``); ``torch.backends.cuda.matmul.
allow_tf32`` stays False, so they are full f32 on the card too.

Decode writes the new K/V into the fixed-capacity cache in place at
``pos`` (the reference's masked update of a donated buffer) and attends
over the whole cache with positions > ``pos`` masked.

Under a mesh, a projection is laid out as its heads fit the mesh before
it is viewed as heads (``specs.unflatten_last``, ``merge_dims``: a
``model`` axis that does not divide the heads leaves them whole, where the
reference's partitioner pads); attention's core runs on each rank's batch
rows and KV heads (``shard_local``), the query heads split as the KV heads
are, where the ``model`` axis divides the KV heads; where it does not, on
each rank's batch rows and ``ceil(h / model)`` query heads, with the KV
heads they read repeated and the last ranks padded with zero heads
(``_split_query_heads``, as the reference's partitioner splits them;
decode's cached cross-attention likewise); prefill emits its caches in
decode's layout (``_emitted_cache``: split along the sequence where the
KV heads do not divide ``model``); decode on DTensor caches writes and
attends on each rank's shard of the sequence (``_decode_sharded``).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import dense_init, split_tree
from repro_torch.sharding import specs as sh
from repro_torch.sharding.specs import logical_constraint as wsc
from repro_torch.sharding.specs import shard_local

NEG_INF = -1e30
SENTINEL = 2**30  # position of padded KV rows: masked causal or not


# the logical axes of the projected heads, and of their weights
Q_AXES = ("batch", "seq", "heads", None)
KV_AXES = ("batch", "seq", "kv_heads", None)
CACHE_AXES = ("batch", "kv_heads", "cache_seq", None)
W_AXES = {Q_AXES: ("fsdp", "heads", None),
          KV_AXES: ("fsdp", "kv_heads", None)}
WO_AXES = ("heads", None, "fsdp")


def init_attention(gen, cfg: ModelConfig):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = common.pdtype(cfg)
    pairs = {
        "wq": dense_init(gen, (d, h, hd), dt, W_AXES[Q_AXES]),
        "wk": dense_init(gen, (d, kv, hd), dt, W_AXES[KV_AXES]),
        "wv": dense_init(gen, (d, kv, hd), dt, W_AXES[KV_AXES]),
        "wo": dense_init(
            gen, (h, hd, d), dt, WO_AXES,
            scale=1.0 / math.sqrt(h * hd),
        ),
    }
    if cfg.qkv_bias:
        z = lambda *shape: torch.zeros(shape, dtype=dt, device=gen.device)
        pairs["bq"] = (z(h, hd), ("heads", None))
        pairs["bk"] = (z(kv, hd), ("kv_heads", None))
        pairs["bv"] = (z(kv, hd), ("kv_heads", None))
    return split_tree(pairs)


def _proj_heads(x, w, ct, axes=Q_AXES):
    """einsum("bsd,dhk->bshk") as one matmul; under a mesh the product is
    laid out as ``axes`` fit the heads before it is viewed as heads."""
    h, k = w.shape[1:]
    y = x @ sh.merge_dims(w.to(ct), 1, W_AXES[axes])
    return sh.unflatten_last(y, (h, k), axes)


def _out_proj(out, wo, ct):
    """einsum("bshk,hkd->bsd") as one matmul."""
    return (sh.merge_dims(out.to(ct), 2, Q_AXES)
            @ sh.merge_dims(wo.to(ct), 0, WO_AXES))


def _project_qkv(params, x, kv_x, positions, kv_positions, cfg: ModelConfig):
    ct = common.cdtype(cfg)
    xq = x.to(ct)
    xkv = (kv_x if kv_x is not None else x).to(ct)
    q = _proj_heads(xq, params["wq"], ct)
    k = _proj_heads(xkv, params["wk"], ct, KV_AXES)
    v = _proj_heads(xkv, params["wv"], ct, KV_AXES)
    if cfg.qkv_bias:
        q = q + params["bq"].to(ct)
        k = k + params["bk"].to(ct)
        v = v + params["bv"].to(ct)
    if cfg.pos_embed == "rope":
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, kv_positions, cfg.rope_theta)
    return wsc(q, Q_AXES), wsc(k, KV_AXES), wsc(v, KV_AXES)


def _group_q(q, n_kv: int):
    """(B,S,H,hd) → (B,S,KV,rep,hd) for GQA."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, hd)


def full_attention(q, k, v, q_pos, k_pos, causal: bool):
    """Reference path for short sequences; fp32 softmax."""
    hd = q.shape[-1]
    scores = torch.einsum(
        "bsgrh,btgh->bgrst", q.float(), k.float()
    ) / math.sqrt(hd)
    if causal:
        mask = q_pos[:, None, None, :, None] >= k_pos[:, None, None, None, :]
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bgrst,btgh->bsgrh", probs.to(q.dtype), v)


def chunked_attention(q, k, v, q_pos, k_pos, causal: bool, q_chunk: int,
                      kv_chunk: int):
    """Online-softmax attention: O(S·chunk) live memory.

    q: (B,S,KV,rep,hd); k/v: (B,T,KV,hd); q_pos (B,S); k_pos (B,T).
    """
    b, s, g, r, hd = q.shape
    t = k.shape[1]
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, t)
    # pad both sequence sides to chunk multiples; padded KV positions get
    # a sentinel so they are masked under causal AND non-causal attention
    s_pad = (-s) % q_chunk
    t_pad = (-t) % kv_chunk
    if s_pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, s_pad))
        q_pos = torch.nn.functional.pad(q_pos, (0, s_pad))
    if t_pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, t_pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, t_pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, t_pad), value=SENTINEL)
    nq, nk = (s + s_pad) // q_chunk, (t + t_pad) // kv_chunk
    scale = 1.0 / math.sqrt(hd)

    outs = []
    for i in range(nq):
        qc = q[:, i * q_chunk:(i + 1) * q_chunk].float()
        qpc = q_pos[:, i * q_chunk:(i + 1) * q_chunk]
        m = torch.full((b, g, r, q_chunk), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l_sum = torch.zeros((b, g, r, q_chunk), dtype=torch.float32,
                            device=q.device)
        acc = torch.zeros((b, g, r, q_chunk, hd), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            kc = k[:, j * kv_chunk:(j + 1) * kv_chunk]
            vc = v[:, j * kv_chunk:(j + 1) * kv_chunk]
            kpc = k_pos[:, j * kv_chunk:(j + 1) * kv_chunk]
            s_blk = torch.einsum("bsgrh,btgh->bgrst", qc, kc.float()) * scale
            valid = (kpc < SENTINEL)[:, None, None, None, :]
            if causal:
                valid = valid & (qpc[:, None, None, :, None]
                                 >= kpc[:, None, None, None, :])
            s_blk = torch.where(valid, s_blk, NEG_INF)
            m_new = torch.maximum(m, s_blk.amax(dim=-1))
            p = torch.exp(s_blk - m_new[..., None])
            corr = torch.exp(m - m_new)
            l_sum = l_sum * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bgrst,btgh->bgrsh", p.to(vc.dtype).float(), vc.float())
            m = m_new
        out = acc / torch.clamp(l_sum[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))  # (b, qc, g, r, hd)
    out = torch.cat(outs, dim=1)[:, :s]
    return out.to(q.dtype)


def attn_forward(params, x, positions, cfg: ModelConfig, causal: bool = True,
                 kv_x=None, kv_positions=None, return_kv: bool = False):
    """Train/prefill attention.  x: (B,S,D) → (B,S,D).

    ``return_kv=True`` additionally returns (k, v) as (B, KV, S, hd) — the
    cache layout — so prefill populates decode caches for free; under a
    mesh a self-attention's laid out as decode's caches
    (``_emitted_cache``).
    """
    if kv_positions is None:
        kv_positions = positions
    q, k, v = _project_qkv(params, x, kv_x, positions, kv_positions, cfg)
    s, t = x.shape[1], k.shape[1]
    if max(s, t) > 2 * cfg.attn_chunk:
        core = lambda *a: chunked_attention(
            *a, causal, q_chunk=cfg.attn_chunk, kv_chunk=cfg.attn_chunk)
    else:
        core = lambda *a: full_attention(*a, causal)

    def grouped(q, k, v, q_pos, k_pos):  # GQA over this rank's KV heads
        return core(_group_q(q, k.shape[2]), k, v, q_pos, k_pos).reshape(
            q.shape)

    split = _query_head_split(q, k.shape[2])
    if split is None:
        # under a mesh whose head axes divide the KV heads, on each rank's
        # batch rows and KV heads (no DTensor einsum rules for these
        # layouts), the query heads split as the KV heads are
        heads, pos = ("batch", None, "kv_heads", None), ("batch", None)
        out = shard_local(grouped, (q, k, v, positions, kv_positions),
                          (heads, heads, heads, pos, pos), heads)
    else:
        out = _split_query_heads(core, q, k, v, (positions, kv_positions),
                                 *split)
    out = wsc(out, Q_AXES)
    y = _out_proj(out, params["wo"], common.cdtype(cfg))
    if return_kv:
        k, v = k.transpose(1, 2), v.transpose(1, 2)
        if kv_x is None:  # a self-attention cache, which decode extends
            k, v = _emitted_cache(k), _emitted_cache(v)
        return y, (k, v)
    return y


def _emitted_cache(t):
    """A (B, KV, S, hd) cache that prefill emits, laid out as decode's
    caches are (``fitted_shardings`` under ``rules_for_shape`` of a decode
    shape, which ``_decode_sharded`` reads): on each rank's KV heads where
    the ``kv_heads`` axes divide them (the projection's layout, as it
    is), else split along S over those axes, so no rank holds every KV
    head of the whole sequence.  Where S does not divide either, whole,
    as ``fitted_spec`` leaves a dim that an axis does not divide.  The
    identity without a mesh and on a plain tensor."""
    mesh, rules = sh.active_mesh(), sh.active_rules()
    if mesh is None or rules is None or not isinstance(t, sh.DTensor):
        return t
    spec = sh.fitted_spec(tuple(t.shape), CACHE_AXES, mesh, rules.with_rule(
        "cache_seq", rules.lookup("kv_heads")))
    want = sh.placements(spec, mesh)
    return t if tuple(t.placements) == want else t.redistribute(mesh, want)


def _query_head_split(q, n_kv: int):
    """Under a mesh whose ``heads`` axes do not divide the ``n_kv`` KV
    heads: (those axes, the ranks along them, this rank's index along
    them); else None (no mesh, one rank along them, or KV heads that
    divide)."""
    mesh, rules = sh.active_mesh(), sh.active_rules()
    if mesh is None or rules is None or not isinstance(q, sh.DTensor):
        return None
    sizes = sh.axis_sizes(mesh)
    batch = sh.fitted_spec((q.shape[0],), ("batch",), mesh, rules)
    axes = tuple(a for a in rules.lookup("heads") or ()
                 if a in sizes and a not in sh.axes_of(batch))
    m = math.prod(sizes[a] for a in axes)
    if m == 1 or n_kv % m == 0:
        return None
    return axes, m, sh.axes_index(mesh, axes)


def _split_query_heads(core, q, k, v, pos, axes, m, index):
    """Attention's core on this rank's batch rows and its ``ceil(h / m)``
    query heads, for a mesh whose ``m`` ranks along the ``heads`` axes do
    not divide the KV heads: each rank takes the KV heads its query heads
    read, repeated once for each of them (the repeat's backward sums their
    gradients back onto the KV heads), and runs them as ``ceil(h / m)``
    groups of one.  Where ``m`` does not divide the query heads either,
    the last ranks' heads are padded with zero heads (a zero query over
    zero values gives zeros), and the padding is sliced off the gathered
    output, so it takes no gradient.  q: (B, S, H, hd); k, v: (B, T, KV,
    hd); ``pos``: (B, ·) tensors passed on to ``core`` after k and v.
    → (B, S, H, hd)."""
    mesh, rules = sh.active_mesh(), sh.active_rules()
    h, kv = q.shape[2], k.shape[2]
    rep, hl = h // kv, -(-h // m)
    q_split = h % m == 0
    head = sh.axes_part(axes)
    batch = sh.fitted_spec((q.shape[0],), ("batch",), mesh, rules)[0]
    q_spec = sh.P(batch, None, head if q_split else None, None)
    kv_spec, pos_spec = sh.P(batch, None, None, None), sh.P(batch, None)
    split = sh.axes_of(q_spec) | set(axes)
    q0 = index * hl
    n = max(0, min(q0 + hl, h) - q0)  # this rank's real query heads
    g0 = q0 // rep
    g1 = (q0 + n - 1) // rep + 1 if n else g0

    def rank_heads(x):  # (b, t, kv, hd) → the KV head of each query head
        b, t, _, hd = x.shape
        x = x[:, :, g0:g1, None].expand(b, t, g1 - g0, rep, hd)
        x = x.reshape(b, t, (g1 - g0) * rep, hd)[:, :, q0 - g0 * rep:][
            :, :, :n]
        return torch.nn.functional.pad(x, (0, 0, 0, hl - n))

    def local(ql, kl, vl, *ps):
        if not q_split:
            ql = torch.nn.functional.pad(ql[:, :, q0:q0 + n],
                                         (0, 0, 0, hl - n))
        kl, vl = rank_heads(kl), rank_heads(vl)
        return core(_group_q(ql, hl), kl, vl, *ps).reshape(ql.shape)

    args = [sh.take_local(a, spec, mesh, split - sh.axes_of(spec))
            for a, spec in ((q, q_spec), (k, kv_spec), (v, kv_spec))
            + tuple((p, pos_spec) for p in pos)]
    out = sh.from_local(local(*args), sh.P(batch, None, head, None), mesh)
    if hl * m == h:
        return out
    whole = sh.placements(sh.P(batch, None, None, None), mesh)
    return out.redistribute(mesh, whole)[:, :, :h]


def _cached_attention(qg, k_cache, v_cache, cfg: ModelConfig, mask=None):
    """(B,1,KV,rep,hd) queries against (B,KV,T,hd) caches → (B,1,H,hd)."""
    scores = torch.einsum(
        "bsgrh,bgth->bgrst", qg.float(), k_cache.float()
    ) / math.sqrt(cfg.hd)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrst,bgth->bsgrh", probs.to(v_cache.dtype), v_cache)
    b, _, g, r, hd = qg.shape
    return out.reshape(b, 1, g * r, hd)


def cross_attn_cached(params, x, k_cache, v_cache, cfg: ModelConfig):
    """Decode-time cross-attention against precomputed (B,KV,F,hd) K/V;
    under a mesh on each rank's query heads, as train's core."""
    ct = common.cdtype(cfg)
    q = _proj_heads(x.to(ct), params["wq"], ct)
    if cfg.qkv_bias:
        q = q + params["bq"].to(ct)
    split = _query_head_split(q, k_cache.shape[1])
    if split is None:
        # under a mesh whose head axes divide the KV heads, on each rank's
        # batch rows and KV heads
        heads, cache = ("batch", None, "kv_heads", None), (
            "batch", "kv_heads", None, None)
        out = shard_local(
            lambda q, k, v: _cached_attention(_group_q(q, k.shape[1]), k,
                                              v, cfg),
            (q, k_cache, v_cache), (heads, cache, cache), heads)
    else:
        # else on its ceil(h / model) query heads, as train's core
        out = _split_query_heads(
            lambda qg, k, v: _cached_attention(
                qg, k.transpose(1, 2), v.transpose(1, 2), cfg),
            q, k_cache.transpose(1, 2), v_cache.transpose(1, 2), (),
            *split)
    return _out_proj(out, params["wo"], ct)


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, n_layers: int,
                  device=None):
    """Stacked KV cache (n_layers leading dim) + logical specs."""
    shape = (n_layers, batch, cfg.n_kv_heads, max_seq, cfg.hd)
    axes = ("layers", "batch", "kv_heads", "cache_seq", None)
    dev = common.resolve_device(device)
    cache = {
        "k": torch.zeros(shape, dtype=common.cdtype(cfg), device=dev),
        "v": torch.zeros(shape, dtype=common.cdtype(cfg), device=dev),
    }
    return cache, {"k": axes, "v": axes}


def attn_decode(params, x, k_cache, v_cache, pos: int, cfg: ModelConfig):
    """One-token decode.  x: (B,1,D); k/v_cache: (B,KV,S,hd); pos: int.

    Writes the new entries into the caches at ``pos`` in place and returns
    (y (B,1,D), k_cache, v_cache).
    """
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, x, None, positions, positions, cfg)
    if isinstance(k_cache, sh.DTensor):
        out = _decode_sharded(q, k, v, k_cache, v_cache, pos, cfg)
        return (_out_proj(out, params["wo"], common.cdtype(cfg)), k_cache,
                v_cache)
    k_cache[:, :, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, :, pos] = v[:, 0].to(v_cache.dtype)
    t_idx = torch.arange(k_cache.shape[2], device=x.device)
    mask = t_idx[None, None, None, None, :] <= pos
    out = _cached_attention(_group_q(q, cfg.n_kv_heads), k_cache, v_cache,
                            cfg, mask)
    return _out_proj(out, params["wo"], common.cdtype(cfg)), k_cache, v_cache


def _decode_sharded(q, k, v, k_cache, v_cache, pos: int, cfg: ModelConfig):
    """``attn_decode``'s write and attention on DTensor caches, each rank
    on its own shard: the rank whose shard of the sequence holds ``pos``
    writes the new K/V there (no rank gathers a cache), each attends over
    its shard, and the softmax's max and sum and the weighted values are
    reduced over the mesh axes that split the sequence.  → (B,1,H,hd)."""
    mesh = k_cache.device_mesh
    spec = sh.spec_of(k_cache)  # (batch, kv_heads, cache_seq, head_dim)
    if spec[3] is not None:
        raise ValueError(f"a KV cache split along head_dim: {spec}")
    start, length = sh.shard_start(k_cache, 2)
    row = sh.P(spec[0], spec[1], None)
    if start <= pos < start + length:
        for cache, new in ((k_cache, k), (v_cache, v)):
            sh.local(cache)[:, :, pos - start] = sh.take_local(
                new[:, 0], row, mesh).to(cache.dtype)
    ql = sh.take_local(q, sh.P(spec[0], None, spec[1], None), mesh)
    kc, vc = sh.local(k_cache), sh.local(v_cache)
    qg = _group_q(ql, kc.shape[1])
    scores = torch.einsum("bsgrh,bgth->bgrst", qg.float(),
                          kc.float()) / math.sqrt(cfg.hd)
    t_idx = start + torch.arange(length, device=scores.device)
    scores = torch.where(t_idx <= pos, scores, NEG_INF)
    seq = spec[2] if isinstance(spec[2], tuple) else (spec[2],)
    groups = [mesh.get_group(a) for a in seq if a is not None]
    m = scores.amax(dim=-1, keepdim=True)
    for g in groups:
        dist.all_reduce(m, dist.ReduceOp.MAX, group=g)
    p = torch.exp(scores - m)
    denom = p.sum(dim=-1, keepdim=True)  # (b, g, r, 1, 1)
    out = torch.einsum("bgrst,bgth->bsgrh", p, vc.float())
    for g in groups:
        dist.all_reduce(denom, group=g)
        dist.all_reduce(out, group=g)
    out = out / denom[..., 0].permute(0, 3, 1, 2)[..., None]
    out = out.to(v_cache.dtype).reshape(ql.shape)
    return sh.from_local(out, sh.P(spec[0], None, spec[1], None), mesh)
