"""The port's sharding (``repro_torch.sharding``, ``launch/mesh.py``, the
MoE's sharded body, the sharded train step, elastic checkpoints and the
train CLI on a mesh) against the reference, on the CPU.

The rules and fitted specs are pure: the reference's cases of
``tests/test_sharding.py`` port case for case.  The multi-rank cases run
on ``gloo`` ranks, spawned (``tests/_torch_ranks.py``: a ``file://`` store
in the test's temp dir, a timeout of their own); the reference's side of
a multi-device case runs in a subprocess with
``--xla_force_host_platform_device_count=8``, beside the ranks.  Inputs
come from numpy seeds; the reference's weights and state cross by
checkpoint or as arrays.  Bounds are the reference's: the (2, 2) step's
loss within 1e-3 and params within 5e-3 of one device's; the EP MoE
within 2e-5 of ``_moe_local`` and its aux within 1e-6.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro.train.optimizer import AdamWConfig as JAdamW  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import common, model  # noqa: E402
from repro_torch.sharding import specs as sh  # noqa: E402
from repro_torch.sharding.specs import P, Rules, fitted_spec  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402

from tests import _torch_ranks as ranks  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
RANKS_TIMEOUT_S = 240
# the (2, 2) step against one device: the reference's bounds
STEP_LOSS_ATOL, STEP_PARAM_ATOL = 1e-3, 5e-3
# the EP MoE against _moe_local: the reference's bounds
MOE_Y_ATOL, MOE_AUX_ATOL = 2e-5, 1e-6
# the ff MoE splits each expert's F contraction in two and sums the halves
# over model: float32 reassociation, a few ulps of |y| (the reference's
# own ff path lands 5.3e-5 from its _moe_local at |y| = 113, 4.7e-7 of
# it; the EP bound, 2e-5 absolute, holds neither package's ff path)
MOE_FF_RTOL = 1e-6
# gradients of the sharded body against _moe_local's, per leaf against
# its max |g| (3.5e-7 seen)
MOE_GRAD_RTOL = 1e-5


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape

    @property
    def axis_names(self):
        return tuple(self.shape)


RULES, JRULES = Rules.make(), jspecs.Rules.make()
MESH = _FakeMesh({"data": 16, "model": 16})
POD_MESH = _FakeMesh({"pod": 2, "data": 16, "model": 16})
LONG = {"cache_seq": ("pod", "data", "model"), "batch": None}

# (shape, logical axes, mesh, rule overrides, the reference test's spec)
FITTED_CASES = {
    "divisible": ((4096, 64, 128), ("fsdp", "heads", None), MESH, None,
                  JP("data", "model", None)),
    "prunes_kv": ((4096, 2, 128), ("fsdp", "kv_heads", None), MESH, None,
                  JP("data", None, None)),
    "prunes_vocab": ((51865, 768), ("vocab", "embed"), MESH, None,
                     JP(None, None)),
    "prefix_of_multi_axis": (
        (9, 1, 8, 524288, 128),
        ("layers", "batch", "kv_heads", "cache_seq", None), POD_MESH, LONG,
        JP(None, None, None, ("pod", "data", "model"), None)),
    "prefix_keeps_pod": ((6,), ("batch",), POD_MESH, None, JP("pod")),
    "no_axis_reuse": ((32, 4096), ("batch", "fsdp"), POD_MESH, None,
                      JP(("pod", "data"), None)),
    "drops_missing_axes": ((64, 64), ("fsdp", "mlp"),
                           _FakeMesh({"data": 4}), None, JP("data", None)),
}


@pytest.mark.parametrize("case", sorted(FITTED_CASES))
def test_fitted_spec_equals_the_reference(case):
    """The cases of ``tests/test_sharding.py``: the port's spec equals the
    reference's expected one and its ``fitted_spec``'s."""
    shape, axes, mesh, over, want = FITTED_CASES[case]
    got = fitted_spec(shape, axes, mesh, Rules.make(over))
    assert got == want
    assert got == jspecs.fitted_spec(shape, axes, mesh,
                                     jspecs.Rules.make(over))


@pytest.mark.parametrize("axis", [None, "pod", "model"])
def test_rules_spec_and_without_axis_equal_the_reference(axis):
    r, jr = RULES, JRULES
    if axis:
        r, jr = r.without_axis(axis), jr.without_axis(axis)
    assert r.table == jr.table
    for axes in [("batch", "seq_sp", "embed"), ("fsdp", "heads", None),
                 ("batch", None, "vocab"), ("experts", "fsdp", None),
                 ("cache_seq", "kv_heads")]:
        for mesh in (MESH, POD_MESH):
            assert r.spec(axes, mesh) == jr.spec(axes, mesh)
    assert sh.DEFAULT_RULES == jspecs.DEFAULT_RULES
    assert sh.LONG_CONTEXT_OVERRIDES == jspecs.LONG_CONTEXT_OVERRIDES
    with pytest.raises(KeyError):
        r.lookup("nope")


class _DimMesh:
    """The two attributes of a DeviceMesh that ``placements`` reads."""

    def __init__(self, shape: dict):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _DimMesh({"pod": 2, "data": 2, "model": 4})
    assert sh.placements(P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.placements(P(None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    # a mesh dim of one device replicates
    one = _DimMesh({"data": 1, "model": 2})
    assert sh.placements(P("data", "model"), one) == (Replicate(), Shard(1))


def test_logical_constraint_and_moe_without_a_mesh():
    """No active mesh: the constraint is the identity and the MoE takes
    the single-shard path."""
    x = torch.ones(2, 3)
    assert sh.logical_constraint(x, ("batch", None)) is x
    assert sh.active_mesh() is None and sh.active_rules() is None
    with sh.use_mesh("m", RULES):
        assert sh.active_mesh() == "m" and sh.active_rules() is RULES
        assert sh.logical_constraint(x, ("batch", None)) is x  # plain
    assert sh.active_mesh() is None


def test_mesh_module_touches_nothing_on_import_and_checks_sizes(tmp_path):
    code = textwrap.dedent(f"""
        import torch.distributed as dist
        from repro_torch.launch import mesh
        assert not dist.is_initialized()
        mesh.init_process_group("cpu", init_method="file://{tmp_path}/s",
                                rank=0, world_size=1)
        m = mesh.make_smoke_mesh(1, 1, device="cpu")
        assert m.mesh_dim_names == ("data", "model") and m.size() == 1
        p = mesh.make_smoke_mesh(1, 1, pod=1, device="cpu")
        assert p.mesh_dim_names == ("pod", "data", "model")
        for bad in ((2, 1), (1, 2)):
            try:
                mesh.make_smoke_mesh(*bad, device="cpu")
            except ValueError as e:
                assert "process group has 1" in str(e)
            else:
                raise AssertionError(bad)
        try:
            mesh.make_production_mesh(device="cpu")
        except ValueError:
            pass
        else:
            raise AssertionError("a 256-device mesh on one rank")
        dist.destroy_process_group()
        print("MESH OK")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0 and "MESH OK" in r.stdout, r.stderr[-3000:]


# ---------------------------------------------------------------------------
# 4 ranks: the (2, 2) step, elastic checkpoints, the CLI (one spawn)
# ---------------------------------------------------------------------------
CLI_ARGS = ["--device", "cpu", "--data", "2", "--model-par", "2", "--rows",
            "20000", "--steps", "3", "--batch", "4", "--seq", "32",
            "--layers", "2"]

_REF = """
import json, sys
import jax, numpy as np, jax.numpy as jnp
from repro.configs import get_config
from repro.launch import train as jtrain
from repro.launch.mesh import make_smoke_mesh
from repro.sharding.specs import Rules
from repro.train import checkpoint as ckpt, steps
from repro.train.optimizer import AdamWConfig
from repro.train.schedule import ScheduleConfig

ref_ckpt, cli_ckpt, cli_args = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
cfg = get_config("qwen1.5-32b").reduced(n_layers=2)
ocfg, scfg = AdamWConfig(), ScheduleConfig(peak_lr=1e-3, warmup_steps=2)
rng = np.random.default_rng(0)
t = rng.integers(0, cfg.vocab, (8, 33)).astype(np.int32)
batch = {"tokens": jnp.asarray(t[:, :-1]), "labels": jnp.asarray(t[:, 1:])}
bs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()}
bspec = {"tokens": ("batch", None), "labels": ("batch", None)}
mesh = make_smoke_mesh(data=2, model=2)
step, shapes, ssh, bsh = steps.jit_train_step(
    cfg, ocfg, scfg, mesh, Rules.make(), bs, bspec)
st = ckpt.restore_checkpoint(ref_ckpt, 0, shapes, ssh)
losses = []
for _ in range(2):
    st, m = step(st, jax.device_put(batch, bsh))
    losses.append(float(m["loss"]))
hist = jtrain.main(cli_args + ["--ckpt-dir", cli_ckpt])
print(json.dumps({"step_losses": losses,
                  "cli_losses": [h["loss"] for h in hist]}))
"""


def _reference(args: list):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    return subprocess.Popen([sys.executable, "-c", _REF, *args], cwd=ROOT,
                            env=env, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The reference's state at step 0 as a checkpoint; then, side by
    side, the reference's (2, 2) step and CLI in a subprocess and the
    port's on 4 gloo ranks (``_torch_ranks.mesh_ranks``)."""
    tmp = tmp_path_factory.mktemp("four_ranks")
    cfg = jconfigs.get_config(ranks.ARCH).reduced(n_layers=2)
    state = jsteps.init_train_state(jax.random.PRNGKey(0), cfg, JAdamW())
    for name in ("ref", "ref_cli", "port_cli"):
        jckpt.save_checkpoint(tmp / name, 0, state)
    ref = _reference([str(tmp / "ref"), str(tmp / "ref_cli"),
                      json.dumps([a for a in CLI_ARGS
                                  if a not in ("--device", "cpu")])])
    try:
        got = ranks.run_ranks(
            ranks.mesh_ranks, 4, tmp, RANKS_TIMEOUT_S,
            ref_ckpt=str(tmp / "ref"), port_ckpt=str(tmp / "port"),
            cli_ckpt=str(tmp / "port_cli"), cli_args=CLI_ARGS)
        out, err = ref.communicate(timeout=RANKS_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    return {"ranks": got, "ref": json.loads(out.strip().splitlines()[-1]),
            "state": jax.tree.map(np.asarray, state), "tmp": tmp}


def _max_abs(a, b) -> float:
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    return max(float(np.max(np.abs(np.asarray(x, np.float32)
                                   - np.asarray(y, np.float32))))
               for x, y in zip(la, lb))


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def test_sharded_step_matches_one_device_and_the_reference(four_ranks):
    """(2 data × 2 model): two steps from the reference's state equal the
    port's one-device steps (loss 1e-3, params 5e-3) and the reference's
    ``jit_train_step`` on the same mesh shape (loss 1e-3); every rank
    holds the same whole params."""
    r0 = four_ranks["ranks"][0]
    ref = four_ranks["ref"]["step_losses"]
    for got, one, want in zip(r0["sharded_losses"], r0["one_losses"], ref):
        assert abs(got - one) < STEP_LOSS_ATOL
        assert abs(got - want) < STEP_LOSS_ATOL
    assert _max_abs(r0["sharded_params"], r0["one_params"]) < STEP_PARAM_ATOL
    # 2 microbatches on the mesh: the same loss, the same gradient norm
    mb = r0["microbatch_metrics"]
    assert abs(mb["loss"] - r0["sharded_losses"][0]) < STEP_LOSS_ATOL
    assert abs(mb["grad_norm"] - r0["grad_norm0"]) < 1e-3 * r0["grad_norm0"]
    for r in four_ranks["ranks"][1:]:
        assert r["sharded_losses"] == r0["sharded_losses"]
        assert _max_abs(r["sharded_params"], r0["sharded_params"]) == 0


def test_int8_adamw_on_sharded_rows_equals_unsharded(four_ranks):
    """Int8 moments of leaves whose rows are split over ``model``: the
    row absmax is taken over the whole row, so params, codes and scales
    equal the unsharded update's, bit for bit."""
    for r in four_ranks["ranks"]:
        plain, shard = r["adamw_int8"][False], r["adamw_int8"][True]
        for a, b in zip(jax.tree.leaves(plain), jax.tree.leaves(shard)):
            assert _same_bits(a, b)


def test_reference_checkpoint_restores_onto_a_mesh(four_ranks):
    """The reference's file, restored onto (2, 2) by every rank and
    gathered back, equals the reference's state bit for bit."""
    want = four_ranks["state"]
    for r in four_ranks["ranks"]:
        got = r["ref_restored"]
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert _same_bits(a, b)


def test_elastic_checkpoint_reshard(four_ranks):
    """Saved on (2, 2) by the port, restored onto (4, 1) as DTensors and
    onto one device: equal bit for bit on every rank."""
    for r in four_ranks["ranks"]:
        assert r["elastic_sharded"]
        assert r["elastic_equal"] == [True, True]


def test_port_sharded_checkpoint_restores_in_the_reference(four_ranks):
    """The port's sharded save (one file a whole leaf, rank 0 writing)
    restores in ``repro.train.checkpoint``, equal to the port's state."""
    cfg = get_config(ranks.ARCH).reduced(n_layers=2)
    want = model.state_to_jax(tsteps.init_train_state(
        common.make_generator(0, "cpu"), cfg, AdamWConfig()))
    jcfg = jconfigs.get_config(ranks.ARCH).reduced(n_layers=2)
    shapes, _ = jsteps.abstract_state(jcfg, JAdamW())
    got = jckpt.restore_checkpoint(four_ranks["tmp"] / "port", 5, shapes)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, got)),
                    jax.tree.leaves(want)):
        assert _same_bits(a, b)


def test_train_cli_on_a_2x2_mesh_matches_the_reference(four_ranks):
    """``--data 2 --model-par 2 --device cpu`` on 4 spawned ranks, resumed
    from the reference's step-0 state: the summary (rank 0's) shows the
    mesh, and its losses are within 1e-3 of ``repro.launch.train``'s at
    the same mesh."""
    s = four_ranks["ranks"][0]["cli"]
    assert s["mesh"] == {"data": 2, "model": 2} and s["dtensor_leaves"]
    assert s["start"] == 0 and s["steps"] == [0, 1, 2]
    want = four_ranks["ref"]["cli_losses"]
    assert len(s["losses"]) == len(want)
    assert np.max(np.abs(np.subtract(s["losses"], want))) < STEP_LOSS_ATOL


# ---------------------------------------------------------------------------
# 8 ranks: the MoE's EP and ff bodies
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def moe_ranks(tmp_path_factory):
    """The reference's MoE weights and input for each case, through the
    port on 8 gloo ranks under (2, 2, 2) and alone."""
    params, xs = {}, {}
    for case, (arch, over) in ranks.MOE_CASES.items():
        cfg = jconfigs.ARCHS[arch].reduced(**over)
        p, _ = jmlp.init_moe(jax.random.PRNGKey(0), cfg)
        params[case] = {k: np.array(v) for k, v in p.items()}
        xs[case] = np.random.default_rng(1).standard_normal(
            (8, 16, cfg.d_model)).astype(np.float32)
    got = ranks.run_ranks(ranks.moe_ranks, 8,
                          tmp_path_factory.mktemp("moe"), RANKS_TIMEOUT_S,
                          params_np=params, x_np=xs)
    return got, params, xs


@pytest.mark.parametrize("case", sorted(ranks.MOE_CASES))
def test_moe_sharded_body_matches_local(moe_ranks, case):
    """On every rank: y and aux against ``_moe_local`` (the EP path at the
    reference's bounds, the ff path at float32 reassociation), the grads
    of the weights and the input against ``_moe_local``'s, finite and
    nonzero; ``_moe_local`` against the reference's."""
    got, params, xs = moe_ranks
    arch, over = ranks.MOE_CASES[case]
    cfg = jconfigs.ARCHS[arch].reduced(**over)
    y_ref, aux_ref = jmlp.moe_forward(params[case], xs[case], cfg)
    for r in got:
        local, shard = r[case][False], r[case][True]
        np.testing.assert_allclose(local["y"], np.asarray(y_ref), atol=2e-5,
                                   rtol=1e-5)
        err = np.max(np.abs(shard["y"] - local["y"]))
        if case == "ep":
            assert err < MOE_Y_ATOL
        else:
            assert err < MOE_FF_RTOL * np.max(np.abs(local["y"]))
        assert abs(shard["aux"] - local["aux"]) < MOE_AUX_ATOL
        assert abs(local["aux"] - float(aux_ref)) < MOE_AUX_ATOL
        for name, g in shard["grads"].items():
            want = local["grads"][name]
            assert np.isfinite(g).all() and np.any(g != 0)
            assert np.max(np.abs(g - want)) <= MOE_GRAD_RTOL * np.max(
                np.abs(want))


# ---------------------------------------------------------------------------
# 4 and 8 ranks: a model axis that does not divide the KV heads
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[(1, 4), (2, 4)],
                ids=["data1_model4", "data2_model4"])
def uneven_ranks(request, tmp_path_factory):
    """``_torch_ranks.uneven_ranks`` on 4 or 8 gloo ranks: ``reduced()``'s
    2 KV heads on a 4-way ``model`` axis, as the production meshes' 16-way
    axis against 2 to 8 KV heads, and 6 heads and 6 KV heads and a
    250-word vocabulary on it, as 40, 24 or 12 heads and a 51,865-word
    vocabulary on 16."""
    shape = request.param
    tmp = tmp_path_factory.mktemp("uneven")
    return shape, ranks.run_ranks(ranks.uneven_ranks, shape[0] * shape[1],
                                  tmp, RANKS_TIMEOUT_S, mesh_shape=shape)


@pytest.mark.parametrize("arch", sorted(ranks.UNEVEN_ARCHS))
def test_steps_on_a_model_axis_that_does_not_divide_the_heads(
        uneven_ranks, arch):
    """A dense GQA arch, the EP MoE, mamba2, a dense arch whose heads
    and vocabulary do not divide ``model`` either and whisper with such
    heads on (1, 4) and (2, 4): two train steps, prefill and four decode
    steps over sequence-split caches (whisper's against its prefill's
    cross-attention caches) equal the one-device port at the (2, 2)
    step's bounds (loss 1e-3; params, logits and caches, prefill's too,
    5e-3); every rank holds the same whole values and takes the same
    greedy tokens.  Each rank's attention core, and whisper's cached
    cross-attention core in decode, sees ``h / model`` query heads, or
    ``ceil(h / model)`` where they are padded, not all h of them; each
    rank holds ``S / model`` positions of prefill's attention caches where
    ``model`` does not divide the KV heads."""
    shape, got = uneven_ranks
    one = got[0][arch][False]
    cfg = get_config(arch).reduced(**ranks.UNEVEN_ARCHS[arch])
    h, kv, s = cfg.n_heads, cfg.n_kv_heads, ranks.step_batch(8)[
        "tokens"].shape[1]
    assert one["core_heads"] == ([h] if h else [])
    assert one["cache_seq"] == [s] * len(one["cache_seq"])
    assert bool(one["cache_seq"]) == bool(kv)
    for r in got:
        sharded = r[arch][True]
        assert sharded["core_heads"] == ([-(-h // shape[1])] if h else [])
        assert sharded["cache_seq"] == [
            s // shape[1] if kv % shape[1] else s] * len(one["cache_seq"])
        assert _max_abs(sharded["prefill_caches"], one["prefill_caches"]) \
            < STEP_PARAM_ATOL
        if cfg.is_encdec:
            assert one["cached_heads"] == [h]
            assert sharded["cached_heads"] == [-(-h // shape[1])]
        for a, b in zip(sharded["losses"], one["losses"]):
            assert abs(a - b) < STEP_LOSS_ATOL
        assert _max_abs(sharded["params"], one["params"]) < STEP_PARAM_ATOL
        assert np.max(np.abs(sharded["prefill"] - one["prefill"])) \
            < STEP_PARAM_ATOL
        for a, b in zip(sharded["decode"], one["decode"]):
            assert np.max(np.abs(a - b)) < STEP_PARAM_ATOL
        assert all(np.array_equal(a, b)
                   for a, b in zip(sharded["tokens"], one["tokens"]))
        assert _max_abs(sharded["caches"], one["caches"]) < STEP_PARAM_ATOL
        first = got[0][arch][True]
        assert sharded["losses"] == first["losses"]
        assert _max_abs(sharded["params"], first["params"]) == 0


@pytest.mark.parametrize("vocab", [256, 250], ids=["split", "whole"])
def test_embedding_looks_up_each_ranks_vocab_slice(vocab, tmp_path):
    """On (1, 4): ``common.embed_lookup`` of a table split along a vocab
    that 4 divides (64 words a rank) equals ``F.embedding`` of the whole
    table bit for bit, and each rank's shard of the table's gradient is
    its slice of the whole table's gradient, bit for bit; a 250-word
    table stays whole on every rank, with the same values."""
    got = ranks.run_ranks(ranks.embed_ranks, 4, tmp_path, RANKS_TIMEOUT_S,
                          vocab=vocab)
    for want, lookup, grad, shard, start in got:
        assert np.array_equal(lookup, want)
        assert shard.shape[0] == (vocab // 4 if vocab % 4 == 0 else vocab)
        assert np.array_equal(shard, grad[start:start + shard.shape[0]])
        assert np.any(shard != 0)
    assert sorted(r[4] for r in got) == (
        [0, 64, 128, 192] if vocab % 4 == 0 else [0] * 4)


def test_remat_recomputes_under_the_forwards_mesh(monkeypatch):
    """A checkpointed layer group's recomputation runs under the mesh and
    rules of its forward, also when backward runs on another thread (the
    autograd engine's own, for CUDA tensors; ``use_mesh`` is
    thread-local)."""
    import threading

    from repro_torch.models import transformer

    cfg = get_config("qwen1.5-32b").reduced(n_layers=2)
    params, _ = model.init_model(common.make_generator(0, "cpu"), cfg)
    seen = []
    slot = transformer.apply_slot

    def watched(*a, **k):
        seen.append((sh.active_mesh(), sh.active_rules()))
        return slot(*a, **k)

    monkeypatch.setattr(transformer, "apply_slot", watched)
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    with torch.enable_grad(), sh.use_mesh("mesh", RULES):
        x = params["tok_embed"].detach().requires_grad_()
        logits, _, _ = transformer.decoder_forward(
            dict(params, tok_embed=x), tokens, cfg)
    worker = threading.Thread(target=lambda: logits.sum().backward())
    worker.start()
    worker.join()
    assert x.grad is not None and sh.active_mesh() is None
    # two groups forward, two recomputed in the backward's thread
    assert seen == [("mesh", RULES)] * 4
