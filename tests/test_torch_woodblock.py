"""WOODBLOCK in the port against ``repro.core.woodblock`` on the CPU.

Exact (``np.array_equal``): the featurizer's rows, ``legal_actions``, the
env's cut matrix, whole episodes under one injected policy (trees,
transitions, rewards), ``per_node_rewards`` in node order and
``make_batch``.  Numerical, at the tolerances below: the network's
forward pass, ``masked_log_softmax``, ``ppo_loss`` and one ``ppo_update``
(parameters and Adam state), with the reference's weights and optimizer
state carried across.  XLA and PyTorch sum the 512-wide products in
different orders, so these agree to float32 rounding, not bit for bit.
Behavioural: the agent on the paper's Fig. 3 scenario.
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import greedy as rgreedy  # noqa: E402
from repro.core import predicates as rpreds  # noqa: E402
from repro.core import rewards as rrewards  # noqa: E402
from repro.core.qdtree import root_desc as rroot_desc  # noqa: E402
from repro.core.woodblock import networks as rnet  # noqa: E402
from repro.core.woodblock import ppo as rppo  # noqa: E402
from repro.core.woodblock.agent import WoodblockConfig as RCfg  # noqa: E402
from repro.core.woodblock.agent import build_woodblock as rbuild  # noqa: E402
from repro.core.woodblock.env import TreeEnv as RTreeEnv  # noqa: E402
from repro.core.woodblock.featurize import Featurizer as RFeat  # noqa: E402
from repro_torch.core import greedy as tgreedy  # noqa: E402
from repro_torch.core import rewards as trewards  # noqa: E402
from repro_torch.core.qdtree import root_desc as troot_desc  # noqa: E402
from repro_torch.core.woodblock import networks as tnet  # noqa: E402
from repro_torch.core.woodblock import ppo as tppo  # noqa: E402
from repro_torch.core.woodblock.agent import (  # noqa: E402
    WoodblockConfig,
    build_woodblock,
)
from repro_torch.core.woodblock.env import TreeEnv  # noqa: E402
from repro_torch.core.woodblock.featurize import Featurizer  # noqa: E402
from tests.test_greedy import fig3_setup  # noqa: E402
from tests.test_torch_engine import _arrays  # noqa: E402

# forward pass, log-softmax and loss: float32 sums of up to 512 products
# in another order
FWD_RTOL, FWD_ATOL = 1e-5, 1e-5
# one PPO update: gradients to float32 rounding, then one Adam step of
# at most lr = 3e-4 per parameter
UPD_RTOL, UPD_ATOL = 1e-4, 1e-6
# the agent on Fig. 3 (seed 0): |port best - reference best| scanned
# fraction on the sample
WOODBLOCK_ABS_TOL = 0.1


def to_port(obj):
    """A ``repro`` dataclass (schema, cut table, workload, query ...)
    rebuilt from the port's class of the same module and name."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        mod = type(obj).__module__
        if mod.startswith("repro."):
            cls = getattr(importlib.import_module("repro_torch" + mod[5:]),
                          type(obj).__name__)
            return cls(**{
                f.name: to_port(getattr(obj, f.name))
                for f in dataclasses.fields(obj) if f.init
            })
    if isinstance(obj, tuple):
        return tuple(to_port(x) for x in obj)
    if isinstance(obj, list):
        return [to_port(x) for x in obj]
    if isinstance(obj, np.ndarray):
        return obj.copy()
    return obj


@pytest.fixture(scope="module")
def envs(tpch_small):
    """The same 3,000-row TPC-H-like sample in both packages' envs."""
    schema, records, work, cuts = tpch_small
    sample = records[:3000]
    ref = RTreeEnv(sample, work, cuts, min_block_sample=120)
    port = TreeEnv(sample, to_port(work), to_port(cuts),
                   min_block_sample=120, device="cpu")
    return ref, port


def injected_policy(seed):
    """A deterministic policy: a uniform legal action from its own numpy
    rng, with logp and value derived from the choice."""
    rng = np.random.default_rng(seed)

    def policy(states, legals):
        acts = np.array(
            [rng.choice(np.nonzero(row)[0]) for row in legals], np.int64
        )
        return acts, -0.01 * acts, states.sum(axis=1) / 100.0

    return policy


def test_featurizer_rows_match_repro(tpch_small, envs):
    schema, _, _, cuts = tpch_small
    ref_env, port_env = envs
    f_ref = RFeat(schema, cuts.n_adv)
    f_port = Featurizer(to_port(schema), cuts.n_adv)
    assert f_port.dim == f_ref.dim
    np.testing.assert_array_equal(
        f_port(troot_desc(to_port(schema), cuts.n_adv)),
        f_ref(rroot_desc(schema, cuts.n_adv)),
    )
    res = ref_env.run_episode(injected_policy(3), np.random.default_rng(3))
    descs = [n.desc for n in res.tree.nodes()]
    got = f_port.batch([to_port(d) for d in descs])
    np.testing.assert_array_equal(got, f_ref.batch(descs))
    assert got.dtype == np.float32


def test_env_cut_matrix_and_legal_actions_match_repro(tpch_small, envs):
    _, records, _, cuts = tpch_small
    ref_env, port_env = envs
    np.testing.assert_array_equal(
        port_env.cut_matrix, rpreds.eval_cuts(records[:3000], cuts)
    )
    assert port_env.cut_matrix.dtype == bool
    ref = ref_env.run_episode(injected_policy(5), np.random.default_rng(5))
    port = port_env.run_episode(injected_policy(5),
                                np.random.default_rng(5))
    for rn, pn in zip(ref.tree.nodes(), port.tree.nodes()):
        np.testing.assert_array_equal(port_env.legal_actions(pn),
                                      ref_env.legal_actions(rn))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_run_episode_matches_repro(envs, seed):
    ref_env, port_env = envs
    ref = ref_env.run_episode(injected_policy(seed),
                              np.random.default_rng(seed))
    port = port_env.run_episode(injected_policy(seed),
                                np.random.default_rng(seed))
    want = _arrays(ref.tree.freeze())
    got = port.tree.freeze().to_arrays()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)
    assert port.scanned_fraction == ref.scanned_fraction
    assert len(port.transitions) == len(ref.transitions) > 0
    for tp, tr in zip(port.transitions, ref.transitions):
        for f in ("state", "legal"):
            np.testing.assert_array_equal(getattr(tp, f), getattr(tr, f))
        assert (tp.action, tp.logp, tp.value, tp.reward) == (
            tr.action, tr.logp, tr.value, tr.reward)


def test_per_node_rewards_match_repro_in_node_order(tpch_small):
    schema, records, work, cuts = tpch_small
    sample = records[:4000]
    ref_tree = rgreedy.build_greedy(sample, work, cuts,
                                    rgreedy.GreedyConfig(min_block=200))
    port_tree = tgreedy.build_greedy(
        sample, to_port(work), to_port(cuts),
        tgreedy.GreedyConfig(min_block=200),
    )
    wt = work.tensorize(cuts)
    twt = to_port(work).tensorize(port_tree.cuts)
    for tighten in (True, False):
        r_rw, r_sf = rrewards.per_node_rewards(ref_tree, sample, wt,
                                               tighten=tighten)
        p_rw, p_sf = trewards.per_node_rewards(port_tree, sample, twt,
                                               tighten=tighten)
        assert p_sf == r_sf
        want = [r_rw.get(id(n)) for n in ref_tree.nodes()]
        got = [p_rw.get(id(n)) for n in port_tree.nodes()]
        assert got == want and any(v is not None for v in got)


@pytest.mark.parametrize("pad", [0, 13])
def test_make_batch_matches_repro(envs, pad):
    ref_env, port_env = envs
    res = port_env.run_episode(injected_policy(7), np.random.default_rng(7))
    cap = len(res.transitions) + pad
    want = rppo.make_batch(res.transitions, cap, ref_env.n_actions,
                           ref_env.feature_dim)
    got = tppo.make_batch(res.transitions, cap, port_env.n_actions,
                          port_env.feature_dim, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, k)


def _carried(envs, seed=0):
    """A reference parameter tree, its port net, and a batch for both."""
    ref_env, port_env = envs
    params = rnet.init_params(jax.random.PRNGKey(seed),
                              ref_env.feature_dim, ref_env.n_actions)
    net = tnet.params_from_jax(jax.tree.map(np.asarray, params))
    res = port_env.run_episode(injected_policy(seed + 11),
                               np.random.default_rng(seed + 11))
    cap = len(res.transitions) + 5
    rb = rppo.make_batch(res.transitions, cap, ref_env.n_actions,
                         ref_env.feature_dim)
    tb = tppo.make_batch(res.transitions, cap, port_env.n_actions,
                         port_env.feature_dim, device="cpu")
    return params, net, rb, tb


def test_forward_and_masked_log_softmax_match_repro(envs):
    params, net, rb, tb = _carried(envs)
    logits, value = rnet.forward(params, rb["states"])
    with torch.no_grad():
        tlogits, tvalue = net(tb["states"])
        tlp = tnet.masked_log_softmax(tlogits, tb["legal"])
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    np.testing.assert_allclose(tvalue.numpy(), np.asarray(value),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    lp = np.asarray(rnet.masked_log_softmax(logits, rb["legal"]))
    legal = np.asarray(rb["legal"])
    np.testing.assert_allclose(tlp.numpy()[legal], lp[legal],
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    # illegal actions sit at the mask value, far below every legal one
    assert (tlp.numpy()[~legal] < -1e37).all()
    assert (lp[~legal] < -1e37).all()


def test_ppo_loss_matches_repro(envs):
    params, net, rb, tb = _carried(envs, seed=1)
    cfg = rppo.PPOConfig()
    total, aux = rppo.ppo_loss(params, rb, cfg)
    with torch.no_grad():
        ttotal, taux = tppo.ppo_loss(net, tb, tppo.PPOConfig())
    np.testing.assert_allclose(float(ttotal), float(total),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    for k in ("policy_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(float(taux[k]), float(aux[k]),
                                   rtol=FWD_RTOL, atol=FWD_ATOL, err_msg=k)


def _flat_params(net) -> dict:
    return {k: p.detach().numpy() for k, p in net.named_parameters()}


def _flat_tree(tree) -> dict:
    return {f"{n}.{k}": np.asarray(tree[n][k])
            for n in tnet.LAYERS for k in ("w", "b")}


@pytest.mark.parametrize("steps", [1, 3])
def test_ppo_update_matches_repro(envs, steps):
    """One update from fresh Adam state, and a third from state carried
    over after two reference updates."""
    params, net, rb, tb = _carried(envs, seed=2)
    cfg = rppo.PPOConfig()
    opt = rppo.adam_init(params)
    for _ in range(steps - 1):
        params, opt, _ = rppo.ppo_update(params, opt, rb, cfg)
    net = tnet.params_from_jax(jax.tree.map(np.asarray, params))
    topt = tppo.adam_state_from_jax(jax.tree.map(np.asarray, opt))
    params, opt, aux = rppo.ppo_update(params, opt, rb, cfg)
    net, topt, taux = tppo.ppo_update(net, topt, tb, tppo.PPOConfig())
    assert topt["t"] == int(opt["t"]) == steps
    np.testing.assert_allclose(float(taux["grad_norm"]),
                               float(aux["grad_norm"]), rtol=FWD_RTOL)
    got, want = _flat_params(net), _flat_tree(params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=UPD_RTOL,
                                   atol=UPD_ATOL, err_msg=k)
    for slot in ("m", "v"):
        want = _flat_tree(opt[slot])
        for k in want:
            np.testing.assert_allclose(
                topt[slot][k].numpy(), want[k], rtol=UPD_RTOL,
                atol=UPD_ATOL * 1e-3, err_msg=f"{slot}[{k}]")


def test_params_from_jax_keeps_the_in_out_layout():
    params = rnet.init_params(jax.random.PRNGKey(4), 7, 5, hidden=16)
    net = tnet.params_from_jax(jax.tree.map(np.asarray, params))
    assert net.fc1.w.shape == (7, 16) and net.policy.w.shape == (16, 5)
    for k, v in _flat_tree(params).items():
        np.testing.assert_array_equal(_flat_params(net)[k], v)


def test_init_is_he_normal_from_the_generator():
    def make(seed):
        gen = torch.Generator().manual_seed(seed)
        return tnet.make_net(300, 40, gen)

    a, b, c = make(0), make(0), make(1)
    pa, pb, pc = _flat_params(a), _flat_params(b), _flat_params(c)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k])
    assert not np.array_equal(pa["fc1.w"], pc["fc1.w"])
    for name in tnet.LAYERS:
        w = pa[f"{name}.w"]
        assert (pa[f"{name}.b"] == 0).all()
        assert abs(w.std() / np.sqrt(2.0 / w.shape[0]) - 1) < 0.1, name


def test_policy_step_samples_legal_actions_from_its_generator(envs):
    _, net, _, tb = _carried(envs, seed=3)
    states, legal = tb["states"], tb["legal"]

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return tppo.policy_step(net, states, legal, gen)

    a, lp, v = draw(9)
    a2, lp2, _ = draw(9)
    assert torch.equal(a, a2) and torch.equal(lp, lp2)
    assert legal[torch.arange(a.shape[0]), a].all()
    with torch.no_grad():
        logits, value = net(states)
        want = tnet.masked_log_softmax(logits, legal)
    assert torch.equal(lp, want.gather(1, a[:, None])[:, 0])
    assert torch.equal(v, value)


def test_woodblock_beats_greedy_on_fig3_like_the_reference():
    """The reference test's criterion (best < 0.6 x greedy, seed 0), and
    the port's best within WOODBLOCK_ABS_TOL of the reference's."""
    schema, records, work, cuts = fig3_setup(n=8_000)
    g = rgreedy.build_greedy(records, work, cuts,
                             rgreedy.GreedyConfig(min_block=40))
    greedy_scanned = rrewards.evaluate_layout(
        g.freeze(), records, work).scanned_fraction
    kw = dict(min_block_sample=40, n_iters=12, episodes_per_iter=4, seed=0)
    ref = rbuild(records, work, cuts, RCfg(**kw))
    port = build_woodblock(records, to_port(work), to_port(cuts),
                           WoodblockConfig(**kw), device="cpu")
    assert port.best_scanned < 0.6 * greedy_scanned, (
        port.best_scanned, greedy_scanned)
    assert abs(port.best_scanned - ref.best_scanned) <= WOODBLOCK_ABS_TOL, (
        port.best_scanned, ref.best_scanned)
    assert port.n_episodes == len(port.curve) == ref.n_episodes
    bests = [p.best_scanned for p in port.curve]
    assert all(b2 <= b1 for b1, b2 in zip(bests, bests[1:]))
    # the best tree is a valid layout of the sample
    frozen = port.best_tree.freeze()
    bids = frozen.route(records)
    assert bids.min() >= 0 and bids.max() < frozen.n_leaves


def test_woodblock_learning_curve_improves(errorlog_small):
    schema, records, work, cuts = errorlog_small
    cfg = WoodblockConfig(min_block_sample=300, n_iters=8,
                          episodes_per_iter=3, seed=1)
    res = build_woodblock(records, to_port(work), to_port(cuts), cfg,
                          device="cpu")
    assert res.best_scanned <= res.curve[0].best_scanned
    assert res.n_episodes == len(res.curve)
