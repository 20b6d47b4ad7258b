"""WOODBLOCK: the deep-RL qd-tree construction agent (paper Sec 5.2).

Training loop: repeatedly construct trees (episodes), score them with the
workload-skipping reward, and refine the policy with PPO.  The best tree
found is deployed (paper: "After attempting a fixed number of trees or if a
timeout is reached, the best tree found is deployed").  A learning curve of
(wall-clock, best/current scan fraction) is recorded to reproduce Fig 8.

This module is the ``"woodblock"`` strategy behind the unified construction
facade — prefer ``repro_torch.service.build_layout(records, workload,
strategy="woodblock", n_iters=...)`` for the common ``LayoutBuild``
artifact (the learning curve lands in ``build.metrics["curve"]``).

The network, its sampling and its PPO updates run on the agent's device
(the GPU unless ``device="cpu"``), drawing from one ``torch.Generator``
seeded with ``cfg.seed``; episodes are host numpy.  Each level of an
episode copies its states in and its actions out once.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import predicates as preds
from repro_torch.core import query as qry
from repro_torch.core.qdtree import QdTree
from repro_torch.core.woodblock import networks, ppo
from repro_torch.core.woodblock.env import TreeEnv


@dataclasses.dataclass
class WoodblockConfig:
    min_block_sample: int  # s·b — min sample records per block (Sec 5.2.1)
    n_iters: int = 40
    episodes_per_iter: int = 4
    time_budget_s: float | None = None
    seed: int = 0
    max_leaves: int | None = None
    allow_small_child: bool = False  # overlap extension (Sec 6.2)
    ppo: ppo.PPOConfig = dataclasses.field(default_factory=ppo.PPOConfig)


@dataclasses.dataclass
class CurvePoint:
    wall_s: float
    episode: int
    current_scanned: float
    best_scanned: float


@dataclasses.dataclass
class WoodblockResult:
    best_tree: QdTree
    best_scanned: float
    curve: list[CurvePoint]
    n_episodes: int


class Woodblock:
    def __init__(
        self,
        sample: np.ndarray,
        workload: qry.Workload,
        cuts: preds.CutTable,
        cfg: WoodblockConfig,
        reward_override=None,
        device=None,
    ):
        self.env = TreeEnv(
            sample,
            workload,
            cuts,
            cfg.min_block_sample,
            allow_small_child=cfg.allow_small_child,
            max_leaves=cfg.max_leaves,
            device=device,
        )
        self.device = self.env.device
        if reward_override is not None:
            # two-tree replication (Sec 6.3) plugs in a modified reward
            self.env_reward_override = reward_override
        else:
            self.env_reward_override = None
        self.cfg = cfg
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self.net = networks.make_net(
            self.env.feature_dim, self.env.n_actions, self.generator,
            device=self.device,
        )
        self.opt_state = ppo.adam_init(self.net)
        self.rng = np.random.default_rng(cfg.seed)

    # -- batched policy for the env: one copy in, one copy out a level -------
    def _policy_fn(self, states: np.ndarray, legals: np.ndarray):
        a, lp, v = ppo.policy_step(
            self.net,
            torch.from_numpy(states).to(self.device),
            torch.from_numpy(legals).to(self.device),
            self.generator,
        )
        # action ids < 2**24 are exact as float32: one copy back
        out = torch.stack([a.to(torch.float32), lp, v]).cpu().numpy()
        return out[0].astype(np.int64), out[1], out[2]

    # -- main loop -----------------------------------------------------------
    def train(self, verbose: bool = False) -> WoodblockResult:
        cfg = self.cfg
        best_tree, best_scanned = None, float("inf")
        curve: list[CurvePoint] = []
        t0 = time.perf_counter()
        episode = 0
        for it in range(cfg.n_iters):
            transitions = []
            for _ in range(cfg.episodes_per_iter):
                result = self.env.run_episode(self._policy_fn, self.rng)
                if self.env_reward_override is not None:
                    self.env_reward_override(result)
                episode += 1
                transitions.extend(result.transitions)
                if result.scanned_fraction < best_scanned:
                    best_scanned = result.scanned_fraction
                    best_tree = result.tree
                curve.append(
                    CurvePoint(
                        wall_s=time.perf_counter() - t0,
                        episode=episode,
                        current_scanned=result.scanned_fraction,
                        best_scanned=best_scanned,
                    )
                )
            if not transitions:
                break
            batch = ppo.make_batch(
                transitions,
                cap=len(transitions),
                n_actions=self.env.n_actions,
                feat_dim=self.env.feature_dim,
                device=self.device,
            )
            for _ in range(cfg.ppo.epochs):
                self.net, self.opt_state, aux = ppo.ppo_update(
                    self.net, self.opt_state, batch, cfg.ppo
                )
            if verbose:
                print(
                    f"iter {it}: episodes={episode} "
                    f"best={best_scanned:.4f} "
                    f"cur={result.scanned_fraction:.4f} "
                    f"pi_loss={float(aux['policy_loss']):.4f} "
                    f"v_loss={float(aux['value_loss']):.4f}"
                )
            if (
                cfg.time_budget_s is not None
                and time.perf_counter() - t0 > cfg.time_budget_s
            ):
                break
        assert best_tree is not None, "no legal cuts at the root"
        return WoodblockResult(
            best_tree=best_tree,
            best_scanned=best_scanned,
            curve=curve,
            n_episodes=episode,
        )


def build_woodblock(
    sample: np.ndarray,
    workload: qry.Workload,
    cuts: preds.CutTable,
    cfg: WoodblockConfig,
    verbose: bool = False,
    device=None,
) -> WoodblockResult:
    return Woodblock(sample, workload, cuts, cfg, device=device).train(
        verbose=verbose
    )
