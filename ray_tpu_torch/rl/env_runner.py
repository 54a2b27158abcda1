"""EnvRunner actors: CPU-side experience collection.

Reference: ``rllib/env/env_runner_group.py`` (née WorkerSet): rollout
actors each stepping vectorized envs with the current policy, gathered
by the algorithm each iteration [UNVERIFIED — mount empty, SURVEY.md
§0].

Counterpart of ``ray_tpu/rl/env_runner.py``, copied. Heterogeneous
resource shape by design: runners are ``num_cpus=1`` actors in process
workers doing numpy policy inference (no device dependency at all, no
torch), while the learner runs on the card in the driver — the
CPU-rollout / GPU-learner split the reference achieves with separate
GPU/CPU actor resource requests.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.rl.env import make_env


def _policy_forward(params: Dict[str, np.ndarray], obs: np.ndarray
                    ) -> np.ndarray:
    """Numpy mirror of the learner's MLP policy head (logits only)."""
    h = np.tanh(obs @ params["w1"] + params["b1"])
    h = np.tanh(h @ params["w2"] + params["b2"])
    return h @ params["wp"] + params["bp"]


class EnvRunner:
    """Actor: owns a vectorized env batch; collects fixed-length
    rollouts with the shipped policy params."""

    def __init__(self, env_name: str, num_envs: int, seed: int = 0):
        self.env = make_env(env_name, num_envs, seed)
        self.rng = np.random.RandomState(seed + 10_000)
        self.obs = self.env.observe()

    def collect(self, params: Dict[str, np.ndarray], rollout_len: int,
                explore_eps: Optional[float] = None
                ) -> Dict[str, np.ndarray]:
        """``explore_eps`` switches sampling to epsilon-greedy over the
        action head (value-based algorithms); None keeps the
        categorical policy sample (policy-gradient algorithms)."""
        T, B = rollout_len, self.env.num_envs
        obs_buf = np.empty((T, B, self.env.obs_dim), np.float32)
        act_buf = np.empty((T, B), np.int32)
        logp_buf = np.empty((T, B), np.float32)
        rew_buf = np.empty((T, B), np.float32)
        done_buf = np.empty((T, B), bool)
        for t in range(T):
            obs_buf[t] = self.obs
            logits = _policy_forward(params, self.obs)
            if explore_eps is not None:
                # epsilon-greedy over the action head; logp records the
                # BEHAVIOR policy's probability (eps/n everywhere plus
                # (1-eps) mass on the greedy action), not the softmax.
                n_act = logits.shape[1]
                greedy = np.argmax(logits, axis=1)
                random_a = self.rng.randint(0, n_act, B)
                explored = self.rng.uniform(size=B) < explore_eps
                actions = np.where(explored, random_a,
                                   greedy).astype(np.int32)
                p_beh = np.full(B, explore_eps / n_act, np.float32)
                p_beh[actions == greedy] += 1.0 - explore_eps
                logp_buf[t] = np.log(p_beh + 1e-9)
            else:
                # Gumbel-max categorical sample + log-prob
                z = logits - logits.max(axis=1, keepdims=True)
                probs = np.exp(z)
                probs /= probs.sum(axis=1, keepdims=True)
                gumbel = -np.log(-np.log(
                    self.rng.uniform(1e-9, 1.0, logits.shape)))
                actions = np.argmax(logits + gumbel,
                                    axis=1).astype(np.int32)
                logp_buf[t] = np.log(
                    probs[np.arange(B), actions] + 1e-9
                ).astype(np.float32)
            act_buf[t] = actions
            self.obs, rew_buf[t], done_buf[t] = self.env.step(actions)
        return {
            "obs": obs_buf, "actions": act_buf, "logp": logp_buf,
            "rewards": rew_buf, "dones": done_buf,
            "last_obs": self.obs.copy(),
            "episode_returns": np.asarray(
                self.env.drain_episode_returns(), np.float32),
        }


class EnvRunnerGroup:
    """Gang of EnvRunner actors, optionally pinned to a placement
    group's CPU bundles."""

    def __init__(self, env_name: str, num_runners: int,
                 num_envs_per_runner: int, seed: int = 0,
                 placement_group=None, bundle_offset: int = 0):
        actor_cls = rt.remote(EnvRunner)
        self._runners = []
        for i in range(num_runners):
            opts: dict = {"num_cpus": 1}
            if placement_group is not None:
                from ray_tpu_torch.util.scheduling_strategies import (
                    PlacementGroupSchedulingStrategy)
                opts["scheduling_strategy"] = \
                    PlacementGroupSchedulingStrategy(
                        placement_group,
                        placement_group_bundle_index=bundle_offset + i)
            self._runners.append(
                actor_cls.options(**opts).remote(
                    env_name, num_envs_per_runner, seed + i * 1000))

    @property
    def num_runners(self) -> int:
        return len(self._runners)

    def collect(self, params: Dict[str, np.ndarray], rollout_len: int,
                explore_eps: Optional[float] = None
                ) -> List[Dict[str, np.ndarray]]:
        refs = [r.collect.remote(params, rollout_len, explore_eps)
                for r in self._runners]
        return rt.get(refs, timeout=300)

    def shutdown(self) -> None:
        for r in self._runners:
            try:
                rt.kill(r)
            except Exception:
                pass    # runner already dead
