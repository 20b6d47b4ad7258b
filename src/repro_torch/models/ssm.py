"""Mamba2 blocks via SSD — state-space duality (arXiv:2405.21060).

Prefill uses the chunked SSD algorithm: intra-chunk terms are
attention-like batched einsums, the inter-chunk state a short loop over
chunk summaries (the reference's ``lax.scan``).  Decode is the O(1)
recurrent update, written into the caches in place.

Shapes: x (B,S,D) → in_proj → [z | xBC | dt]; causal depthwise conv over
xBC; SSD over heads (H = d_inner / head_dim) with G B/C groups of state N.

Under a mesh the projection's channels are gathered whole on each rank's
batch rows (a ``model`` split of them does not fall on the z | xBC | dt
cut); the SSD runs on each rank's batch rows and heads (``_ssd``, B and C
broadcast to the heads first), and decode on DTensor caches updates each
rank's shards in place (``_decode_sharded``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import dense_init, split_tree
from repro_torch.sharding import specs as sh
from repro_torch.sharding.specs import logical_constraint as wsc

SSD_CHUNK = 256


def _dims(cfg: ModelConfig):
    d_in = cfg.d_inner
    g, n, p = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    h = cfg.ssm_heads
    conv_ch = d_in + 2 * g * n
    proj_out = 2 * d_in + 2 * g * n + h  # z, xBC, dt
    return d_in, g, n, p, h, conv_ch, proj_out


def init_mamba(gen, cfg: ModelConfig):
    d = cfg.d_model
    d_in, g, n, p, h, conv_ch, proj_out = _dims(cfg)
    dt = common.pdtype(cfg)
    dev = gen.device
    # dt bias initialized so softplus(dt_bias) spans [1e-3, 1e-1]
    u = torch.rand((h,), generator=gen, dtype=torch.float32, device=dev)
    dt_init = torch.log(torch.expm1(torch.exp(u * 4.6 - 6.9)))
    conv_w = torch.randn((cfg.ssm_conv, conv_ch), generator=gen,
                         dtype=torch.float32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    pairs = {
        "in_proj": dense_init(gen, (d, proj_out), dt, ("fsdp", "mlp")),
        "out_proj": dense_init(gen, (d_in, d), dt, ("mlp", "fsdp")),
        "conv_w": ((0.1 * conv_w).to(dt), (None, "mlp")),
        "conv_b": (torch.zeros((conv_ch,), dtype=dt, device=dev), ("mlp",)),
        "A_log": (torch.zeros((h,), **f32), ("ssm_heads",)),
        "D": (torch.ones((h,), **f32), ("ssm_heads",)),
        "dt_bias": (dt_init, ("ssm_heads",)),
        "norm": (torch.ones((d_in,), dtype=dt, device=dev), ("mlp",)),
    }
    return split_tree(pairs)


def _segsum(a):
    """a: (..., Q) → (..., Q, Q) cumulative sums over segments i≥j."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dt, a_log, b_mat, c_mat, init_state=None,
                chunk=SSD_CHUNK):
    """SSD over chunks.

    x: (B,S,H,P) — pre-multiplied inputs (x·dt applied here)
    dt: (B,S,H) — softplus'd step sizes
    a_log: (H,) — A = -exp(a_log)
    b_mat/c_mat: (B,S,G,N); heads are grouped G → H by repetition.
    Returns (y (B,S,H,P), final_state (B,H,P,N)).
    """
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    rep = h // g
    a = -torch.exp(a_log)  # (H,)
    da = dt * a  # (B,S,H)
    xd = x * dt[..., None]

    def resh(t_, tail):
        return t_.reshape((bsz, nc, chunk) + tail)

    xc = resh(xd, (h, p))
    dac = resh(da, (h,))
    bc = resh(b_mat, (g, n))
    cc = resh(c_mat, (g, n))
    # broadcast groups → heads
    bh = torch.repeat_interleave(bc, rep, dim=3)  # (B,nc,Q,H,N)
    ch = torch.repeat_interleave(cc, rep, dim=3)

    a_cs = torch.cumsum(dac, dim=2)  # (B,nc,Q,H)
    # intra-chunk (attention-like) term
    l_mat = torch.exp(_segsum(dac.permute(0, 1, 3, 2)))  # (B,nc,H,Q,Q)
    scores = torch.einsum("bcihn,bcjhn->bchij", ch, bh) * l_mat
    y_diag = torch.einsum("bchij,bcjhp->bcihp", scores, xc)

    # chunk summary states
    decay_states = torch.exp(a_cs[:, :, -1:, :] - a_cs)  # (B,nc,Q,H)
    states = torch.einsum("bcjhn,bcjh,bcjhp->bchpn", bh, decay_states, xc)

    # inter-chunk recurrence over chunk summaries
    a_tot = torch.exp(a_cs[:, :, -1, :])  # (B,nc,H)
    prev = (torch.zeros((bsz, h, p, n), dtype=x.dtype, device=x.device)
            if init_state is None else init_state)
    entering = []  # the state *entering* each chunk
    for c in range(nc):
        entering.append(prev)
        prev = prev * a_tot[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(entering, dim=1)  # (B,nc,H,P,N)

    # inter-chunk output term
    state_decay = torch.exp(a_cs)  # (B,nc,Q,H)
    y_off = torch.einsum(
        "bcihn,bchpn,bcih->bcihp", ch, prev_states, state_decay
    )
    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y, prev


HEADS = ("batch", "seq", "ssm_heads", None)
STATE = ("batch", "ssm_heads", None, None)


def _ssd(x, dt, a_log, b_mat, c_mat, init_state, chunk: int):
    """``ssd_chunked``; under a mesh on each rank's batch rows and heads
    (its einsums have no DTensor rule for a head split beside a group
    split), B and C first broadcast from their groups to the heads."""
    if sh.active_mesh() is None or not isinstance(x, sh.DTensor):
        return ssd_chunked(x, dt, a_log, b_mat, c_mat, init_state, chunk)
    bsz, s, h, _ = x.shape
    g, n = b_mat.shape[2:]

    def per_head(t):
        return t[:, :, :, None, :].expand(bsz, s, g, h // g, n).reshape(
            bsz, s, h, n)

    args = (x, dt, a_log, per_head(b_mat), per_head(c_mat))
    axes = (HEADS, HEADS[:3], ("ssm_heads",), HEADS, HEADS)
    if init_state is not None:
        args, axes = args + (init_state,), axes + (STATE,)
    return sh.shard_local(
        lambda *a: ssd_chunked(*a[:5], a[5] if len(a) > 5 else None, chunk),
        args, axes, (HEADS, STATE))


def _conv1d_causal(xbc, w, bias):
    """Depthwise causal conv.  xbc: (B,S,C); w: (K,C)."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    s = xbc.shape[1]
    out = torch.zeros_like(xbc, dtype=torch.float32)  # laid out as xbc
    for i in range(k):
        out = out + pad[:, i:i + s, :].float() * w[i].float()
    return (out + bias.float()).to(xbc.dtype)


def _split_proj(proj, cfg: ModelConfig):
    d_in, g, n, p, h, conv_ch, _ = _dims(cfg)
    z = proj[..., :d_in]
    xbc = proj[..., d_in:d_in + conv_ch]
    dt = proj[..., d_in + conv_ch:]
    return z, xbc, dt


def mamba_forward(params, x, cfg: ModelConfig, init_state=None):
    """Train/prefill.  x: (B,S,D) → (y, final_state, conv_tail), where
    conv_tail is the last K-1 pre-conv activations (B, K-1, C) — the decode
    conv cache."""
    ct = common.cdtype(cfg)
    d_in, g, n, p, h, conv_ch, _ = _dims(cfg)
    bsz, s, _ = x.shape
    # under a mesh the channels whole: a split of them does not fall on
    # the z | xBC | dt cut
    proj = sh.batch_only(x.to(ct) @ params["in_proj"].to(ct))
    z, xbc, dt = _split_proj(proj, cfg)
    k = cfg.ssm_conv
    if s >= k - 1:
        # a copy: a view would hold the whole projection alive as a cache
        conv_tail = xbc[:, s - (k - 1):, :].clone()
    else:
        conv_tail = F.pad(xbc, (0, 0, k - 1 - s, 0))
    xbc = sh.batch_only(_conv1d_causal(xbc, params["conv_w"],
                                       params["conv_b"]))
    xbc = F.silu(xbc)
    xs = xbc[..., :d_in].reshape(bsz, s, h, p)
    b_mat = xbc[..., d_in:d_in + g * n].reshape(bsz, s, g, n)
    c_mat = xbc[..., d_in + g * n:].reshape(bsz, s, g, n)
    dt = F.softplus(dt.float() + params["dt_bias"])
    xs = wsc(xs, HEADS)
    y, final = _ssd(xs.float(), dt, params["A_log"], b_mat.float(),
                    c_mat.float(), init_state, cfg.ssd_chunk)
    y = y + params["D"][None, None, :, None] * xs.float()
    y = sh.merge_dims(y, 2, HEADS).to(ct)
    y = common.rmsnorm(y * F.silu(z.to(ct)), params["norm"], cfg.norm_eps)
    return y @ params["out_proj"].to(ct), final, conv_tail


def init_mamba_cache(cfg: ModelConfig, batch: int, n_layers: int,
                     device=None):
    d_in, g, n, p, h, conv_ch, _ = _dims(cfg)
    dev = common.resolve_device(device)
    cache = {
        "state": torch.zeros((n_layers, batch, h, p, n), dtype=torch.float32,
                             device=dev),
        "conv": torch.zeros((n_layers, batch, cfg.ssm_conv - 1, conv_ch),
                            dtype=common.cdtype(cfg), device=dev),
    }
    specs = {
        "state": ("layers", "batch", "ssm_heads", None, None),
        "conv": ("layers", "batch", None, "mlp"),
    }
    return cache, specs


def mamba_decode(params, x, state, conv_state, cfg: ModelConfig):
    """One-token recurrent update.  x: (B,1,D); state: (B,H,P,N);
    conv_state: (B,K-1,C).  Writes the new state and conv window into
    ``state`` and ``conv_state`` in place; returns (y, state, conv_state).
    """
    if isinstance(state, sh.DTensor):
        return _decode_sharded(params, x, state, conv_state, cfg)
    ct = common.cdtype(cfg)
    d_in, g, n, p, h, conv_ch, _ = _dims(cfg)
    bsz = x.shape[0]
    proj = x.to(ct) @ params["in_proj"].to(ct)  # (B,1,proj)
    z, xbc, dt = _split_proj(proj, cfg)
    window = torch.cat([conv_state, xbc], dim=1)  # (B,K,C)
    w = params["conv_w"].float()  # (K,C)
    conv_out = (window.float() * w[None]).sum(dim=1) + params[
        "conv_b"].float()
    conv_state.copy_(window[:, 1:])
    xbc = F.silu(conv_out)  # (B,C) fp32
    xs = xbc[:, :d_in].reshape(bsz, h, p)
    b_t = xbc[:, d_in:d_in + g * n].reshape(bsz, g, n)
    c_t = xbc[:, d_in + g * n:].reshape(bsz, g, n)
    rep = h // g
    b_h = torch.repeat_interleave(b_t, rep, dim=1)  # (B,H,N)
    c_h = torch.repeat_interleave(c_t, rep, dim=1)
    dtv = F.softplus(dt[:, 0].float() + params["dt_bias"])
    a = -torch.exp(params["A_log"])  # (H,)
    da = torch.exp(dtv * a)  # (B,H)
    xdt = xs * dtv[..., None]  # (B,H,P)
    new_state = state * da[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", xdt, b_h)
    state.copy_(new_state)
    y = torch.einsum("bhpn,bhn->bhp", new_state, c_h) + params["D"][
        None, :, None] * xs
    y = y.reshape(bsz, 1, d_in).to(ct)
    y = common.rmsnorm(y * F.silu(z.to(ct)), params["norm"], cfg.norm_eps)
    return y @ params["out_proj"].to(ct), state, conv_state


def _decode_sharded(params, x, state, conv_state, cfg: ModelConfig):
    """``mamba_decode`` on DTensor caches, each rank on its own shards:
    its conv window's channels and its heads' states are updated in place
    (no rank gathers a cache); the conv output's channels are gathered for
    the heads' inputs, and the heads' outputs stay split for the gated
    norm and the output projection."""
    ct = common.cdtype(cfg)
    d_in, g, n, p, h, conv_ch, _ = _dims(cfg)
    mesh = state.device_mesh
    proj = sh.batch_only(x.to(ct) @ params["in_proj"].to(ct))  # (B,1,proj)
    z, xbc, dt = _split_proj(proj, cfg)
    sspec, cspec = sh.spec_of(state), sh.spec_of(conv_state)
    rows = sh.P(cspec[0], None, None)
    whole = lambda t: sh.take_local(t, sh.P(*[None] * t.dim()), mesh)
    c0, cl = sh.shard_start(conv_state, 2)
    window = torch.cat([sh.local(conv_state),
                        sh.take_local(xbc, rows, mesh)[..., c0:c0 + cl]],
                       dim=1)  # (b, K, C_l)
    w = whole(params["conv_w"]).float()[:, c0:c0 + cl]
    conv_out = (window.float() * w[None]).sum(dim=1) + whole(
        params["conv_b"]).float()[c0:c0 + cl]
    sh.local(conv_state).copy_(window[:, 1:])
    xbc = sh.take_local(sh.from_local(conv_out, sh.P(cspec[0], cspec[2]),
                                      mesh), sh.P(cspec[0], None), mesh)
    xbc = F.silu(xbc)  # (b, C) fp32, every channel
    h0, hl = sh.shard_start(state, 1)
    heads = slice(h0, h0 + hl)
    bl = xbc.shape[0]
    xs = xbc[:, :d_in].reshape(bl, h, p)[:, heads]
    b_h = torch.repeat_interleave(
        xbc[:, d_in:d_in + g * n].reshape(bl, g, n), h // g, dim=1)[:, heads]
    c_h = torch.repeat_interleave(
        xbc[:, d_in + g * n:].reshape(bl, g, n), h // g, dim=1)[:, heads]
    dtv = F.softplus(sh.take_local(dt, rows, mesh)[:, 0, heads].float()
                     + whole(params["dt_bias"])[heads])
    a = -torch.exp(whole(params["A_log"])[heads])
    da = torch.exp(dtv * a)
    xdt = xs * dtv[..., None]
    st = sh.local(state)
    new_state = st * da[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", xdt, b_h)
    st.copy_(new_state)
    y = torch.einsum("bhpn,bhn->bhp", new_state, c_h) + whole(
        params["D"])[heads][None, :, None] * xs
    y = sh.from_local(y.reshape(bl, 1, hl * p), sh.P(sspec[0], None,
                                                     sspec[1]), mesh)
    y = common.rmsnorm(y.to(ct) * F.silu(z.to(ct)), params["norm"],
                       cfg.norm_eps)
    return y @ params["out_proj"].to(ct), state, conv_state
