"""The port's LM training (``repro_torch.train``) against ``repro.train``,
on the CPU, from one carried state.

Inputs are drawn with numpy from fixed seeds and go through both
packages; the reference's state crosses with ``state_from_jax`` and comes
back, for comparison, in the reference's stacked layout with
``state_to_jax``.  Both run float32 and sum in other orders (XLA's dots
against PyTorch's), so float values agree to float32 rounding at the
tolerances below; int8 moments agree exactly but for a ±1 at a rounding
tie.  Checkpoints cross between the packages bit for bit.

Also here, ported from ``tests/test_train.py``: the schedule's shape, the
grad clip, microbatch equivalence, the straggler watch, checkpoint gc and
latest, failure injection and resume, and the int8-moment test.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import schedule as jsched  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import schedule as tsched  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train.loop import (  # noqa: E402
    FailureInjector, LoopConfig, StragglerWatch, maybe_restore, train_loop)

ARCHS = sorted(configs.ARCHS)
ARCH = "qwen1.5-32b"
# the schedule: float32 on both sides, cos in XLA's and in libm's
SCHED_RTOL = 1e-6
# AdamW from identical grads: elementwise float32, one rounding apart at
# most a step (3.1e-6 of a leaf's max seen, grok's int8 scales); int8
# codes equal or ±1 where x / scale sits on a .5 tie
OPT_RTOL = 1e-5
# gradients of train_loss, per leaf against that leaf's max |g| (global
# norms agree to 1.3e-6 relative)
GRAD_RTOL = 1e-4
# three train steps: the loss, the moments and the params after two real
# updates (lr 2e-4, 4e-4), against each leaf's max |x| (1.5e-6 seen);
# plus an absolute floor for the params of a leaf whose gradient is
# noise: a key bias shifts a query's scores nearly alike, and Adam's
# m̂/√v̂ turns noise into a step of ~lr (2.3e-7 apart seen on ``bk``)
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6


def reduced(arch, **kw):
    over = dict(kw)
    if configs.get_config(arch).n_experts:
        over.setdefault("capacity_factor", 8.0)
    return (jconfigs.get_config(arch).reduced(**over),
            configs.get_config(arch).reduced(**over))


def make_batch(cfg, b, s, seed):
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


def to_t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def carried_state(jcfg, tcfg, jocfg, tocfg, seed=0):
    js = jsteps.init_train_state(jax.random.PRNGKey(seed), jcfg, jocfg)
    return js, tmodel.state_from_jax(np_tree(js), tcfg, tocfg, "cpu")


def paired(ref, got):
    """(key, reference leaf, port leaf) over two trees in the reference's
    layout, with equal paths, shapes and dtypes."""
    ra = jax.tree_util.tree_flatten_with_path(np_tree(ref))[0]
    ga = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in ra] == [p for p, _ in ga]
    for (path, a), (_, b) in zip(ra, ga):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        yield jax.tree_util.keystr(path), a, b


def by_path(tree, path=""):
    """{path: leaf} of a port tree (dicts and lists)."""
    if not isinstance(tree, (dict, list)):
        return {path: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(by_path(v, f"{path}/{k}"))
    return out


def assert_leafwise(ref, got, rtol, what="", atol=0.0):
    """Every float leaf within ``rtol`` of its own max |x| (plus
    ``atol``); int8 codes within 1; integers equal."""
    for key, a, b in paired(ref, got):
        if a.dtype == np.int8:
            assert np.abs(a.astype(np.int32) - b).max() <= 1, what + key
        elif a.dtype.kind == "i":
            assert np.array_equal(a, b), what + key
        else:
            scale = max(float(np.abs(a).max()), 1e-30)
            err = float(np.abs(a.astype(np.float64) - b).max())
            assert err <= rtol * scale + atol, f"{what}{key}: {err} vs " \
                f"{scale}"


# ---------------------------------------------------------------------------
# schedule and quantization
# ---------------------------------------------------------------------------
def test_warmup_cosine_equals_the_reference():
    for cfg in [dict(peak_lr=1e-3, warmup_steps=5, total_steps=100),
                dict(peak_lr=3e-4, warmup_steps=2, total_steps=6),
                dict(peak_lr=1.0, warmup_steps=0, total_steps=10)]:
        j, t = jsched.ScheduleConfig(**cfg), tsched.ScheduleConfig(**cfg)
        want = np.asarray(jsched.warmup_cosine(jnp.arange(100), j))
        got = tsched.warmup_cosine(torch.arange(100), t)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=SCHED_RTOL)
        for s in (0, 3, 99):  # an int and a 0-d int32 tensor
            one = jsched.warmup_cosine(jnp.asarray(s, jnp.int32), j)
            for step in (s, torch.tensor(s, dtype=torch.int32)):
                np.testing.assert_allclose(
                    float(tsched.warmup_cosine(step, t)), float(one),
                    rtol=SCHED_RTOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_and_dequantize_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((6, 40)) * 10 ** rng.uniform(-6, 2)
         ).astype(np.float32)
    x[0] = 0.0  # an all-zero row takes the 1e-20 floor
    x[1, :4] = [1.0, -0.5, 0.25, 127.0]  # exact codes
    want = jopt.quantize(jnp.asarray(x))
    got = topt.quantize(torch.from_numpy(x))
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == \
        torch.float32 and tuple(got["scale"].shape) == (6, 1)
    assert np.array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    diff = np.abs(got["q"].numpy().astype(np.int32)
                  - np.asarray(want["q"], np.int32))
    tie = np.isclose(np.abs(x / np.asarray(want["scale"])) % 1, 0.5)
    assert diff.max() <= 1 and not (diff & ~tie).any()
    np.testing.assert_array_equal(
        topt.dequantize({"q": torch.from_numpy(np.array(want["q"])),
                         "scale": got["scale"]}).numpy(),
        np.asarray(jopt.dequantize(want)))


def test_quantize_roundtrip_property():
    try:
        from hypothesis import given, settings, strategies as st
    except ImportError:  # tier-1 containers without hypothesis
        from tests._hypothesis_shim import given, settings, st

    @settings(max_examples=30, deadline=None)
    @given(st.integers(0, 2**31 - 1))
    def run(seed):
        rng = np.random.default_rng(seed)
        x = torch.from_numpy((rng.standard_normal((8, 64))
                              * 10 ** rng.uniform(-6, 2)).astype(np.float32))
        err = (topt.dequantize(topt.quantize(x)) - x).abs().numpy()
        bound = x.abs().amax(dim=1, keepdim=True).numpy() / 127 + 1e-12
        assert (err <= bound + 1e-9).all()

    run()


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("eight_bit", [False, True])
def test_adamw_update_equals_the_reference(eight_bit):
    """Three updates from one carried state (reduced grok: dense and MoE
    leaves), the same grads fed to both: params, moments, count and the
    grad norm."""
    jcfg, tcfg = reduced("grok-1-314b")
    jo, to = (jopt.AdamWConfig(eight_bit=eight_bit),
              topt.AdamWConfig(eight_bit=eight_bit))
    js, ts = carried_state(jcfg, tcfg, jo, to)
    jp, jstate = js["params"], js["opt"]
    tp, tstate = ts["params"], ts["opt"]
    rng = np.random.default_rng(1)
    update = jax.jit(lambda p, g, o: jopt.adamw_update(p, g, o, 1e-3, jo))
    for _ in range(3):
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape)
                                    * 10 ** rng.uniform(-4, 0))
                         .astype(np.float32), jp)
        jp, jstate, jn = update(jp, g, jstate)
        tp, tstate, tn = topt.adamw_update(
            tp, tmodel.params_from_jax(g, tcfg, "cpu"), tstate, 1e-3, to)
        np.testing.assert_allclose(float(tn), float(jn), rtol=OPT_RTOL)
    quantized = [k for k, a, _ in paired(jstate, tmodel.state_to_jax(tstate))
                 if a.dtype == np.int8]
    assert bool(quantized) == eight_bit
    # the reference's stacked rank: per-layer norm scales are quantized
    assert any("ln1" in k for k in quantized) == eight_bit
    assert_leafwise({"p": jp, "o": jstate},
                    tmodel.state_to_jax({"p": tp, "o": tstate}), OPT_RTOL)


def test_opt_specs_and_abstract_state_mirror_the_state():
    _, tcfg = reduced("jamba-1.5-large-398b")
    to = topt.AdamWConfig(eight_bit=True)
    shapes, specs = tsteps.abstract_state(tcfg, to)
    assert all(t.device.type == "meta" for t in tmodel.leaves(shapes))
    real = tsteps.init_train_state(
        torch.Generator().manual_seed(0), tcfg, to)
    flat = lambda t: [(tuple(x.shape), x.dtype) for x in tmodel.leaves(t)]
    assert flat(shapes) == flat(real)
    for t, s in zip(tmodel.leaves(real["opt"]["m"]),
                    tmodel.leaves(specs["opt"]["m"])):
        assert len(s) == t.dim()
    jcfg, _ = reduced("jamba-1.5-large-398b")
    jshapes, _ = jsteps.abstract_state(jcfg, jopt.AdamWConfig(eight_bit=True))
    # the reference's layout: equal paths, shapes and dtypes
    assert len(list(paired(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                        jshapes),
                           tmodel.state_to_jax(real)))) > 0


# ---------------------------------------------------------------------------
# gradients and the step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_grads_equal_the_reference(arch):
    jcfg, tcfg = reduced(arch)
    jp, _ = jmodel.init_model(jax.random.PRNGKey(0), jcfg)
    tp = tmodel.params_from_jax(np_tree(jp), tcfg, "cpu")
    batch = make_batch(jcfg, 2, 16, seed=3)
    (jl, _), jg = jax.value_and_grad(jmodel.train_loss, has_aux=True)(
        jp, to_j(batch), jcfg)
    tg, metrics = tsteps.loss_and_grads(tp, to_t(batch), tcfg)
    it = iter(tg)
    tg = tmodel.tree_map(lambda _: next(it), tp)
    np.testing.assert_allclose(float(metrics["loss"]), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(topt.global_norm(tg)),
                               float(jopt.global_norm(jg)), rtol=1e-5)
    assert_leafwise(jg, tmodel.state_to_jax(tg), GRAD_RTOL, arch + " ")


def _stream(cfg, seed, b=8, s=32):
    rng = np.random.default_rng(seed)
    while True:
        t = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
        yield {"tokens": t[:, :-1], "labels": t[:, 1:]}


SCFG = dict(peak_lr=1e-3, warmup_steps=5, total_steps=100)


def test_three_train_steps_equal_the_reference():
    jcfg, tcfg = reduced(ARCH, n_layers=2)
    jo, to = jopt.AdamWConfig(), topt.AdamWConfig()
    js, ts = carried_state(jcfg, tcfg, jo, to)
    jsc, tsc = jsched.ScheduleConfig(**SCFG), tsched.ScheduleConfig(**SCFG)
    step = jax.jit(lambda s, b: jsteps.train_step(s, b, jcfg, jo, jsc))
    it = _stream(jcfg, 5)
    for _ in range(3):
        batch = next(it)
        js, jm = step(js, to_j(batch))
        ts, tm = tsteps.train_step(ts, to_t(batch), tcfg, to, tsc)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=STEP_RTOL, atol=1e-9)
    assert int(ts["step"]) == 3 and int(ts["opt"]["count"]) == 3
    assert_leafwise(js, tmodel.state_to_jax(ts), STEP_RTOL, atol=STEP_ATOL)


def _one_step(cfg, batch, state=None, steps=1):
    o = topt.AdamWConfig()
    if state is None:
        state = tsteps.init_train_state(
            torch.Generator().manual_seed(0), cfg, o)
    sc = tsched.ScheduleConfig(**SCFG)
    for _ in range(steps):
        state, m = tsteps.train_step(state, to_t(batch), cfg, o, sc)
    return state, m


def test_microbatch_equivalence():
    """4 microbatches against 1: the first step has lr 0, so compare the
    moments it leaves (m = 0.1·clip·g), then the params after a second."""
    _, tcfg = reduced(ARCH, n_layers=2)
    mb = dataclasses.replace(tcfg, microbatches=4)
    batch = next(_stream(tcfg, 2))
    a, ma = _one_step(tcfg, batch)
    b, mbm = _one_step(mb, batch)
    np.testing.assert_allclose(float(mbm["loss"]), float(ma["loss"]),
                               rtol=1e-6)
    for x, y in zip(tmodel.leaves(a["opt"]), tmodel.leaves(b["opt"])):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-4,
                                   atol=1e-9)
    a, _ = _one_step(tcfg, batch, a)
    b, _ = _one_step(mb, batch, b)
    for x, y in zip(tmodel.leaves(a["params"]), tmodel.leaves(b["params"])):
        np.testing.assert_allclose(y.numpy(), x.numpy(), atol=2e-5)


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "whisper-small",
                                  "jamba-1.5-large-398b"])
def test_remat_on_equals_off(arch):
    """Recomputing a group's forward in the backward changes no value."""
    _, tcfg = reduced(arch)
    params, _ = tmodel.init_model(torch.Generator().manual_seed(0), tcfg)
    batch = to_t(make_batch(tcfg, 2, 16, seed=4))
    on, m_on = tsteps.loss_and_grads(params, batch, tcfg)
    off, m_off = tsteps.loss_and_grads(
        params, batch, dataclasses.replace(tcfg, remat=False))
    assert float(m_on["loss"]) == float(m_off["loss"])
    for x, y in zip(on, off):
        assert torch.equal(x, y)


def test_remat_saves_only_group_inputs():
    """With remat the autograd graph keeps a group's inputs, not its
    activations: fewer saved tensors than without."""
    _, tcfg = reduced(ARCH, n_layers=4)
    params, _ = tmodel.init_model(torch.Generator().manual_seed(0), tcfg)
    batch = to_t(make_batch(tcfg, 2, 16, seed=4))

    def saved(cfg):
        count = [0]

        def pack(t):
            count[0] += 1
            return t

        live = [p.detach().requires_grad_() for p in tmodel.leaves(params)]
        it = iter(live)
        tree = tmodel.tree_map(lambda _: next(it), params)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            tmodel.train_loss(tree, batch, cfg)
        return count[0]

    assert saved(tcfg) < saved(dataclasses.replace(tcfg, remat=False)) / 2


def test_loss_decreases_and_schedule_shape():
    _, tcfg = reduced(ARCH, n_layers=2)
    it = _stream(tcfg, 0)
    state, losses = None, []
    for _ in range(15):
        state, m = _one_step(tcfg, next(it), state)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] and all(np.isfinite(losses))
    sc = tsched.ScheduleConfig(**SCFG)
    lr = tsched.warmup_cosine(torch.arange(0, 100), sc)
    assert float(lr[0]) == 0.0
    assert abs(float(lr[5]) - sc.peak_lr) < 1e-9
    assert float(lr[99]) < sc.peak_lr
    assert float(lr[99]) >= sc.final_frac * sc.peak_lr * 0.99


def test_grad_clip_applied():
    """Above ``max_grad_norm`` the grads are scaled to it: the first
    step's m is (1-b1)·g·max/‖g‖; and a huge lr stays finite."""
    _, tcfg = reduced(ARCH, n_layers=2)
    o = topt.AdamWConfig(max_grad_norm=0.1)
    state = tsteps.init_train_state(torch.Generator().manual_seed(0), tcfg, o)
    batch = to_t(next(_stream(tcfg, 0)))
    grads, _ = tsteps.loss_and_grads(state["params"], batch, tcfg)
    hot = tsched.ScheduleConfig(peak_lr=1.0, warmup_steps=0, total_steps=10)
    s1, m = tsteps.train_step(state, batch, tcfg, o, hot)
    norm = float(m["grad_norm"])
    assert norm > 5 * o.max_grad_norm
    for g, mom in zip(grads, tmodel.leaves(s1["opt"]["m"])):
        np.testing.assert_allclose(mom.numpy(), (1 - o.b1) * g.numpy()
                                   * o.max_grad_norm / norm,
                                   rtol=1e-5, atol=1e-12)
    assert all(bool(torch.isfinite(x).all())
               for x in tmodel.leaves(s1["params"]))


O8_FP32_GAP = 0.4  # tests/test_train.py:72


def test_int8_optimizer_tracks_fp32():
    """``tests/test_train.py``'s assertions, from the port's own init.
    The reference fails them from its own (loss 5.9290 → 5.9395 over 15
    steps): int8 v rounds to 0 where m does not (the next test), and the
    step there is m̂/eps, so the run is chaotic and whether the last of
    15 noisy losses ends below the first is chance.  Here: 6.0374 →
    5.9249, 0.075 from fp32's."""
    _, tcfg = reduced(ARCH, n_layers=2)
    o32, o8 = topt.AdamWConfig(), topt.AdamWConfig(eight_bit=True)
    sc = tsched.ScheduleConfig(**SCFG)
    s32 = tsteps.init_train_state(torch.Generator().manual_seed(0), tcfg,
                                  o32)
    s8 = tsteps.init_train_state(torch.Generator().manual_seed(0), tcfg, o8)
    a, b = [], []
    it1, it2 = _stream(tcfg, 1), _stream(tcfg, 1)
    for _ in range(15):
        s32, m32 = tsteps.train_step(s32, to_t(next(it1)), tcfg, o32, sc)
        s8, m8 = tsteps.train_step(s8, to_t(next(it2)), tcfg, o8, sc)
        a.append(float(m32["loss"]))
        b.append(float(m8["loss"]))
    assert any(x.dtype == torch.int8 for x in tmodel.leaves(s8["opt"]["m"]))
    assert b[-1] < b[0]
    assert abs(a[-1] - b[-1]) < O8_FP32_GAP


def test_int8_moments_round_small_v_to_zero():
    """The cause of the failure above, in the port and the reference
    alike: after the first step a third of ``head``'s int8 codes of v are
    0 where m's are not (0.351 in the reference), so the next step there
    is m̂/eps."""
    jcfg, tcfg = reduced(ARCH, n_layers=2)
    jo, to = jopt.AdamWConfig(eight_bit=True), topt.AdamWConfig(
        eight_bit=True)
    js, ts = carried_state(jcfg, tcfg, jo, to)
    batch = next(_stream(tcfg, 1))
    sc = tsched.ScheduleConfig(**SCFG)
    js, _ = jax.jit(lambda s, b: jsteps.train_step(
        s, b, jcfg, jo, jsched.ScheduleConfig(**SCFG)))(js, to_j(batch))
    ts, _ = tsteps.train_step(ts, to_t(batch), tcfg, to, sc)
    for opt in (np_tree(js["opt"]), tmodel.state_to_jax(ts["opt"])):
        mq, vq = opt["m"]["head"]["q"], opt["v"]["head"]["q"]
        assert ((vq == 0) & (mq != 0)).mean() > 0.25


# ---------------------------------------------------------------------------
# the loop and checkpoints
# ---------------------------------------------------------------------------
def test_straggler_watch_flags_outlier():
    fired = []
    w = StragglerWatch(z=3.0, warmup=5,
                       on_straggle=lambda s, dt, mu: fired.append(s))
    for i in range(20):
        w.observe(i, 0.1 + 0.001 * (i % 3))
    w.observe(20, 5.0)
    assert fired == [20] and w.flagged == 1


def _cpu_state(cfg, eight_bit=False):
    return tsteps.init_train_state(torch.Generator().manual_seed(0), cfg,
                                   topt.AdamWConfig(eight_bit=eight_bit))


def test_checkpoint_roundtrip_and_gc(tmp_path):
    _, tcfg = reduced("jamba-1.5-large-398b")
    state = _cpu_state(tcfg, eight_bit=True)
    state, _ = tsteps.train_step(state, to_t(next(_stream(tcfg, 0, 2, 16))),
                                 tcfg, topt.AdamWConfig(eight_bit=True),
                                 tsched.ScheduleConfig(**SCFG))
    for s in (1, 2, 3, 4):
        tckpt.save_checkpoint(tmp_path, s, state, keep=2)
    assert tckpt.all_steps(tmp_path) == [3, 4]
    assert tckpt.latest_step(tmp_path) == 4
    shapes, _ = tsteps.abstract_state(tcfg,
                                      topt.AdamWConfig(eight_bit=True))
    back = tckpt.restore_checkpoint(tmp_path, 4, shapes, device="cpu")
    for a, b in zip(tmodel.leaves(state), tmodel.leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    t = tckpt.save_checkpoint(tmp_path / "async", 7, state, async_save=True)
    t.join(timeout=60)
    assert not t.is_alive() and tckpt.latest_step(tmp_path / "async") == 7


def test_bf16_leaves_keep_their_bits(tmp_path):
    _, tcfg = reduced(ARCH, n_layers=2, param_dtype="bfloat16")
    state = _cpu_state(tcfg)
    tckpt.save_checkpoint(tmp_path, 1, state)
    head = np.load(tmp_path / "step_1" / "params__head.npy")
    assert head.dtype.kind == "V" and head.dtype.itemsize == 2
    shapes, _ = tsteps.abstract_state(tcfg, topt.AdamWConfig())
    back = tckpt.restore_checkpoint(tmp_path, 1, shapes, device="cpu")
    assert back["params"]["head"].dtype == torch.bfloat16
    for a, b in zip(tmodel.leaves(state), tmodel.leaves(back)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("eight_bit", [False, True])
def test_reference_checkpoint_restores_in_the_port(tmp_path, eight_bit):
    jcfg, tcfg = reduced("jamba-1.5-large-398b")
    jo, to = (jopt.AdamWConfig(eight_bit=eight_bit),
              topt.AdamWConfig(eight_bit=eight_bit))
    rng = np.random.default_rng(0)
    # every leaf drawn at random in its own dtype (a checkpoint does not
    # care what the numbers mean)
    js = jax.tree.map(
        lambda x: jnp.asarray((rng.integers(-127, 128, x.shape)
                               if x.dtype == jnp.int8 else
                               rng.integers(0, 99, x.shape) if
                               x.dtype == jnp.int32 else
                               rng.standard_normal(x.shape)).astype(x.dtype)),
        jsteps.init_train_state(jax.random.PRNGKey(0), jcfg, jo))
    jckpt.save_checkpoint(tmp_path, 1, js)
    shapes, _ = tsteps.abstract_state(tcfg, to)
    back = tckpt.restore_checkpoint(tmp_path, 1, shapes, device="cpu")
    want = tmodel.state_from_jax(np_tree(js), tcfg, to, "cpu")
    got, want = by_path(back), by_path(want)
    assert got.keys() == want.keys()
    for k, a in got.items():
        assert a.dtype == want[k].dtype, k
        assert np.array_equal(a.numpy(), want[k].numpy()), k


@pytest.mark.parametrize("eight_bit", [False, True])
def test_port_checkpoint_restores_in_the_reference(tmp_path, eight_bit):
    jcfg, tcfg = reduced("jamba-1.5-large-398b")
    jo, to = (jopt.AdamWConfig(eight_bit=eight_bit),
              topt.AdamWConfig(eight_bit=eight_bit))
    state = _cpu_state(tcfg, eight_bit)
    state, _ = tsteps.train_step(state, to_t(next(_stream(tcfg, 0, 2, 16))),
                                 tcfg, to, tsched.ScheduleConfig(**SCFG))
    tckpt.save_checkpoint(tmp_path, 1, state)
    shapes, _ = jsteps.abstract_state(jcfg, jo)
    back = jckpt.restore_checkpoint(tmp_path, 1, shapes)
    names = {p.name for p in (tmp_path / "step_1").iterdir()}
    assert names == {f"{jckpt._leaf_key(p)}.npy" for p, _ in
                     jax.tree_util.tree_flatten_with_path(back)[0]} | {
        "manifest.json"}
    for _, a, b in paired(back, tmodel.state_to_jax(state)):
        assert np.array_equal(a, b)


def test_failure_injection_and_resume(tmp_path):
    _, tcfg = reduced(ARCH, n_layers=2)
    o, sc = topt.AdamWConfig(), tsched.ScheduleConfig(**SCFG)
    step_fn = lambda s, b: tsteps.train_step(s, to_t(b), tcfg, o, sc)
    lcfg = LoopConfig(total_steps=12, ckpt_dir=str(tmp_path), ckpt_every=4,
                      log_every=0)
    it = _stream(tcfg, 3)
    with pytest.raises(RuntimeError, match="injected failure"):
        train_loop(step_fn, _cpu_state(tcfg), it, lcfg,
                   failure=FailureInjector(fail_at_step=9))
    shapes, _ = tsteps.abstract_state(tcfg, o)
    st, step = maybe_restore(str(tmp_path), shapes, device="cpu")
    assert step == 8
    st2, hist = train_loop(step_fn, st, it, lcfg)
    assert int(st2["step"]) == 12
    assert [h["step"] for h in hist] == [8, 9, 10, 11]
    assert all(h["wall_s"] > 0 and np.isfinite(h["loss"]) for h in hist)
    assert maybe_restore(None, shapes) == (None, 0)
