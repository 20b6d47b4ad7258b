"""The port's LM stack (``repro_torch.{configs,models}``) against
``repro``'s, on the CPU, with the reference's weights carried across.

For each of the ten archs at ``reduced()`` the reference's params
(``repro.models.model.init_model``) go through ``params_from_jax``; then
the forward logits, the prefill logits and caches, and every decode
step's logits (after each package's ``_splice``) are compared.  The MoE
routing (kept-token counts, aux loss), the SSD scan and the chunked
attention are compared on their own.  Everything runs in float32 (the
reduced configs' compute dtype); the two packages sum in other orders,
so values agree to float32 rounding: ``RTOL``/``ATOL`` below.

Also here: the port's own prefill↔decode consistency for the five
families (as ``tests/test_models.py`` checks the reference's), and the
logical-axis spec ranks.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch.serve_lm import _splice as jsplice  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.serve_lm import _splice as tsplice  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402

ARCHS = sorted(configs.ARCHS)
FAMILIES = ["qwen1.5-32b", "mamba2-780m", "jamba-1.5-large-398b",
            "whisper-small", "qwen3-moe-235b-a22b"]
# float32 on both sides; the sums run in other orders (XLA's dots and
# einsums against PyTorch's), so logits of magnitude ~1 differ by a few
# float32 ulps per layer: up to 1.2e-5 seen (jamba, 16 layers)
RTOL, ATOL = 1e-4, 5e-5


def reduced(arch, **kw):
    """The same reduced config in both packages (MoE at capacity 8, as
    ``tests/test_models.py`` runs it, unless ``kw`` says otherwise)."""
    over = dict(kw)
    if configs.get_config(arch).n_experts:
        over.setdefault("capacity_factor", 8.0)
    return (jconfigs.get_config(arch).reduced(**over),
            configs.get_config(arch).reduced(**over))


def make_batch(cfg, b, s, seed):
    """numpy inputs, as ``tests/test_models.py::make_batch`` draws them."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.n_image_patches:
        batch["patches"] = (0.01 * rng.standard_normal(
            (b, cfg.n_image_patches, cfg.d_model))).astype(np.float32)
    if cfg.is_encdec:
        batch["frames"] = (0.01 * rng.standard_normal(
            (b, 16, cfg.d_model))).astype(np.float32)
    return batch


def carried(jcfg, tcfg, seed=0):
    """(reference params, the port's params_from_jax of them)."""
    jp, _ = jmodel.init_model(jax.random.PRNGKey(seed), jcfg)
    np_params = jax.tree.map(np.asarray, jp)
    return jp, tmodel.params_from_jax(np_params, tcfg, device="cpu")


def to_t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=what)


def layout(tree, path=""):
    """{path: (shape, dtype)} of a params tree (dicts and lists)."""
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree))
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(layout(v, f"{path}{k}/"))
        else:
            out[f"{path}{k}"] = (tuple(v.shape), v.dtype)
    return out


def cache_items(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from cache_items(v, f"{path}{k}/")
        else:
            yield f"{path}{k}", v


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    ref, port = jconfigs.get_config(arch), configs.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(
        ref.reduced())
    assert [dataclasses.astuple(s) for s in ttr.layer_program(port)] == [
        dataclasses.astuple(s) for s in jtr.layer_program(ref)]
    if not port.is_encdec:
        assert ttr.n_groups(port) == jtr.n_groups(ref)
    assert tmodel.model_flops_per_token(port) == \
        jmodel.model_flops_per_token(ref)


def test_shape_table_and_cells_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert configs.SUBQUADRATIC_FAMILIES == jconfigs.SUBQUADRATIC_FAMILIES
    assert configs.runnable_cells() == jconfigs.runnable_cells()
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("no-such-arch")


# ---------------------------------------------------------------------------
# params: spec ranks, the carried tree
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_ranks_and_carried_layout(arch):
    """Every port leaf has a logical-axes tuple of its rank; the port's own
    init and the carried reference params have the same leaves (shape and
    dtype), and as many parameters as the reference."""
    jcfg, tcfg = reduced(arch)
    params, specs = tmodel.init_model(tcommon.make_generator(0, "cpu"), tcfg)
    pl = list(tmodel.leaves(params))
    sl = list(tmodel.leaves(specs))
    assert len(pl) == len(sl) > 0
    for p, s in zip(pl, sl):
        assert isinstance(s, tuple) and len(s) == p.ndim
    jp, tp = carried(jcfg, tcfg)
    assert layout(tp) == layout(params)
    assert tmodel.param_count(tp) == tmodel.param_count(params) == \
        jmodel.param_count(jp)


def test_params_keep_the_reference_dtypes():
    """bf16 params stay bf16; the router and the SSM's A_log, D, dt_bias
    stay float32, as the reference made them."""
    jcfg, tcfg = reduced("jamba-1.5-large-398b", param_dtype="bfloat16")
    jp, tp = carried(jcfg, tcfg)
    mamba = tp["layers"][0]["slot0"]
    assert mamba["mix"]["in_proj"].dtype == torch.bfloat16
    for name in ("A_log", "D", "dt_bias"):
        assert mamba["mix"][name].dtype == torch.float32
    moe = tp["layers"][0]["slot1"]["mlp"]
    assert moe["router"].dtype == torch.float32
    assert moe["w_up"].dtype == torch.bfloat16
    want = np.asarray(jp["layers"]["slot1"]["mlp"]["w_up"][1], np.float32)
    assert np.array_equal(
        tp["layers"][1]["slot1"]["mlp"]["w_up"].float().numpy(), want)


# ---------------------------------------------------------------------------
# the whole model, with carried weights
# ---------------------------------------------------------------------------
def _ref_forward(jp, batch, jcfg):
    if jcfg.is_encdec:
        enc = jencdec.encode(jp, batch["frames"], jcfg)
        logits, _ = jencdec.decode_train(jp, enc, batch["tokens"], jcfg)
        return logits, jnp.zeros(())
    logits, aux, _ = jtr.decoder_forward(
        jp, batch["tokens"], jcfg, patches=batch.get("patches"))
    return logits, aux


def _port_forward(tp, batch, tcfg):
    with torch.no_grad():
        if tcfg.is_encdec:
            enc = tencdec.encode(tp, batch["frames"], tcfg)
            logits, _ = tencdec.decode_train(tp, enc, batch["tokens"], tcfg)
            return logits, torch.zeros(())
        logits, aux, _ = ttr.decoder_forward(
            tp, batch["tokens"], tcfg, patches=batch.get("patches"))
        return logits, aux


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_equal_the_reference(arch):
    jcfg, tcfg = reduced(arch)
    jp, tp = carried(jcfg, tcfg, seed=2)
    batch = make_batch(tcfg, 2, 32, seed=1)
    want, want_aux = _ref_forward(jp, to_j(batch), jcfg)
    got, got_aux = _port_forward(tp, to_t(batch), tcfg)
    close(got, want, what="logits")
    close(got_aux, want_aux, what="aux loss")
    with torch.no_grad():
        loss, metrics = tmodel.train_loss(tp, to_t(batch), tcfg)
    jloss, jmetrics = jmodel.train_loss(jp, to_j(batch), jcfg)
    close(loss, jloss, what="loss")
    close(metrics["nll"], jmetrics["nll"], what="nll")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_every_decode_step_equal_the_reference(arch):
    """Prefill logits and caches, then greedy-free decode of the batch's
    own next tokens: every step's logits and the caches at the end."""
    jcfg, tcfg = reduced(arch)
    jp, tp = carried(jcfg, tcfg, seed=1)
    B, S, plen = 2, 20, 12  # llava's 8 patch slots lie inside the prompt
    batch = make_batch(tcfg, B, S, seed=3)
    pre = dict(batch, tokens=batch["tokens"][:, :plen])
    jlast, jpre = jmodel.prefill(jp, to_j(pre), jcfg)
    tlast, tpre = tmodel.prefill(tp, to_t(pre), tcfg)
    close(tlast, jlast, what="prefill logits")
    jpre_items = dict(cache_items(jpre))
    for path, t in cache_items(tpre):
        close(t, jpre_items[path], what=f"prefill cache {path}")

    jc, _ = jmodel.init_caches(jcfg, B, S)
    jc = jsplice(jcfg, jc, jpre, plen)
    tc, _ = tmodel.init_caches(tcfg, B, S, device="cpu")
    tc = tsplice(tcfg, tc, tpre, plen)
    step = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, c, t, pos,
                                                           jcfg))
    for t in range(plen, S):
        tok = batch["tokens"][:, t:t + 1]
        jl, jc = step(jp, jc, jnp.asarray(tok), jnp.int32(t))
        tl, tc = tmodel.decode_step(tp, tc, torch.from_numpy(tok), t, tcfg)
        close(tl, jl, what=f"decode logits at {t}")
    jitems = dict(cache_items(jc))
    for path, t in cache_items(tc):
        close(t, jitems[path], what=f"decode cache {path}")


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_consistency(arch):
    """The port alone: teacher-forced logits at position t equal the
    decode-step logits at t (GQA KV caches, the SSD state recurrence, the
    hybrid interleave, enc-dec cross caches, MoE at capacity 8), at the
    tolerance of ``tests/test_models.py``."""
    _, tcfg = reduced(arch)
    B, S = 2, 16
    batch = to_t(make_batch(tcfg, B, S, seed=3))
    params, _ = tmodel.init_model(tcommon.make_generator(1, "cpu"), tcfg)
    full, _ = _port_forward(params, batch, tcfg)
    plen = S // 2
    _, pre = tmodel.prefill(
        params, dict(batch, tokens=batch["tokens"][:, :plen]), tcfg)
    caches, _ = tmodel.init_caches(tcfg, B, S, device="cpu")
    caches = tsplice(tcfg, caches, pre, plen)
    for t in range(plen, S):
        logits, caches = tmodel.decode_step(
            params, caches, batch["tokens"][:, t:t + 1], t, tcfg)
        close(logits, full[:, t].numpy(), rtol=2e-2, atol=2e-2,
              what=f"step {t}")


# ---------------------------------------------------------------------------
# the pieces: MoE routing, SSD, chunked attention, RoPE and norms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,factor", [
    ("qwen3-moe-235b-a22b", 8.0), ("qwen3-moe-235b-a22b", 0.5),
    ("grok-1-314b", 1.0), ("jamba-1.5-large-398b", 0.5),
])
def test_moe_local_equals_the_reference(arch, factor):
    """Routing, capacity positions, kept-token counts per expert, the
    layer's output and its aux loss; below factor 1 tokens are dropped."""
    jcfg, tcfg = reduced(arch, capacity_factor=factor)
    gen = tcommon.make_generator(5, "cpu")
    tparams, _ = tmlp.init_moe(gen, tcfg)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in tparams.items()}
    rng = np.random.default_rng(4)
    T = 48
    xf = rng.standard_normal((T, tcfg.d_model)).astype(np.float32)
    jprobs, jtop_p, jtop_e = jmlp._route(jparams, jnp.asarray(xf), jcfg)
    probs, top_p, top_e = tmlp._route(tparams, torch.from_numpy(xf), tcfg)
    close(probs, jprobs, what="probs")
    close(top_p, jtop_p, what="top_p")
    assert np.array_equal(top_e.numpy(), np.asarray(jtop_e))
    cap = tmlp._capacity(T, tcfg)
    assert cap == jmlp._capacity(T, jcfg)
    e, k = tcfg.n_experts, tcfg.top_k
    got = tmlp._bucket(top_e, T, k, e, cap)
    want = jmlp._bucket(jtop_e, T, k, e, cap)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    keep, sorted_e = got[4].numpy(), got[1].numpy()
    kept = np.bincount(sorted_e[keep], minlength=e)
    assert kept.max() <= cap
    if factor < 1.0:
        assert keep.sum() < T * k  # the capacity did drop tokens
    with torch.no_grad():
        y, aux = tmlp.moe_forward(
            tparams, torch.from_numpy(xf).reshape(2, T // 2, -1), tcfg)
    jy, jaux = jmlp._moe_local(jparams, jnp.asarray(xf), jcfg)
    close(y.reshape(T, -1), jy, what="moe output")
    close(aux, jaux, what="aux loss")


@pytest.mark.parametrize("chunk,with_init", [(8, False), (8, True),
                                              (32, True)])
def test_ssd_chunked_and_mamba_decode_equal_the_reference(chunk, with_init):
    """The chunked scan (y and final state, over several chunks, from a
    given state) and three recurrent decode steps (state and conv window)."""
    rng = np.random.default_rng(chunk + with_init)
    B, S, H, P, G, N = 2, 32, 4, 8, 2, 16
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    a_log = (0.3 * rng.standard_normal(H)).astype(np.float32)
    bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    init = (rng.standard_normal((B, H, P, N)).astype(np.float32)
            if with_init else None)
    jy, jfin = jssm.ssd_chunked(
        *map(jnp.asarray, (x, dt, a_log, bm, cm)),
        init_state=None if init is None else jnp.asarray(init), chunk=chunk)
    ty, tfin = tssm.ssd_chunked(
        *map(torch.from_numpy, (x, dt, a_log, bm, cm)),
        init_state=None if init is None else torch.from_numpy(init),
        chunk=chunk)
    close(ty, jy, what="ssd y")
    close(tfin, jfin, what="ssd final state")

    jcfg, tcfg = reduced("mamba2-780m")
    jp, tp = carried(jcfg, tcfg, seed=3)
    jmix = jax.tree.map(lambda a: a[0], jp["layers"]["slot0"]["mix"])
    tmix = tp["layers"][0]["slot0"]["mix"]
    _, g, n, p, h, conv_ch, _ = tssm._dims(tcfg)
    state = rng.standard_normal((B, h, p, n)).astype(np.float32)
    conv = rng.standard_normal((B, tcfg.ssm_conv - 1, conv_ch)).astype(
        np.float32)
    jstate, jconv = jnp.asarray(state), jnp.asarray(conv)
    tstate, tconv = torch.from_numpy(state.copy()), torch.from_numpy(
        conv.copy())
    for _ in range(3):
        xt = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
        jy, jstate, jconv = jssm.mamba_decode(jmix, jnp.asarray(xt), jstate,
                                              jconv, jcfg)
        ty, _, _ = tssm.mamba_decode(tmix, torch.from_numpy(xt), tstate,
                                     tconv, tcfg)
        close(ty, jy, what="decode y")
        close(tstate, jstate, what="decode state")
        close(tconv, jconv, what="decode conv window")


@pytest.mark.parametrize("s,t,causal", [(40, 40, True), (37, 37, True),
                                        (24, 45, False)])
def test_chunked_attention_equals_the_reference(s, t, causal):
    """Query × KV chunks of 16 with ragged tails (padded, the KV tail
    masked by its sentinel), and the full path beside it."""
    rng = np.random.default_rng(s + t)
    B, G, R, hd = 2, 2, 2, 16
    q = rng.standard_normal((B, s, G, R, hd)).astype(np.float32)
    k = rng.standard_normal((B, t, G, hd)).astype(np.float32)
    v = rng.standard_normal((B, t, G, hd)).astype(np.float32)
    qp = np.broadcast_to(np.arange(s, dtype=np.int32), (B, s)).copy()
    kp = np.broadcast_to(np.arange(t, dtype=np.int32), (B, t)).copy()
    args = (q, k, v, qp, kp)
    want = jattn.chunked_attention(*map(jnp.asarray, args), causal, 16, 16)
    got = tattn.chunked_attention(*map(torch.from_numpy, args), causal, 16,
                                  16)
    close(got, want, what="chunked")
    full = tattn.full_attention(*map(torch.from_numpy, args), causal)
    close(full, jattn.full_attention(*map(jnp.asarray, args), causal),
          what="full")
    close(got, full.numpy(), what="chunked against full")


def test_rope_norms_and_cross_entropy_equal_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 5)).astype(np.int32)
    close(tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             10_000.0),
          jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0),
          what="rope")
    # the half-split pairs: dimension i rotates against i + hd/2
    one = np.zeros((1, 1, 1, 16), np.float32)
    one[..., 0] = 1.0
    rot = tcommon.apply_rope(torch.from_numpy(one),
                             torch.ones((1, 1), dtype=torch.int32), 1.0)
    assert rot[..., 8].item() == pytest.approx(np.sin(1.0), abs=1e-6)
    h = rng.standard_normal((3, 64)).astype(np.float32)
    sc = rng.standard_normal(64).astype(np.float32)
    bi = rng.standard_normal(64).astype(np.float32)
    close(tcommon.rmsnorm(torch.from_numpy(h), torch.from_numpy(sc), 1e-6),
          jcommon.rmsnorm(jnp.asarray(h), jnp.asarray(sc), 1e-6))
    close(tcommon.layernorm(torch.from_numpy(h), torch.from_numpy(sc),
                            torch.from_numpy(bi), 1e-6),
          jcommon.layernorm(jnp.asarray(h), jnp.asarray(sc),
                            jnp.asarray(bi), 1e-6))
    lg = rng.standard_normal((2, 4, 32)).astype(np.float32)
    lab = rng.integers(0, 32, (2, 4)).astype(np.int32)
    w = (rng.random((2, 4)) > 0.3).astype(np.float32)
    for wt in (None, w):
        got = tcommon.softmax_cross_entropy(
            torch.from_numpy(lg), torch.from_numpy(lab),
            None if wt is None else torch.from_numpy(wt))
        want = jcommon.softmax_cross_entropy(
            jnp.asarray(lg), jnp.asarray(lab),
            None if wt is None else jnp.asarray(wt))
        for g_, w_ in zip(got, want):
            close(g_, w_)


def test_entry_points_default_to_the_gpu():
    """No device means the GPU: without one, the generator, the caches and
    the carried weights raise rather than fall back to the CPU."""
    _, tcfg = reduced("mamba2-780m")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcommon.make_generator(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.init_caches(tcfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.params_from_jax({}, tcfg)
