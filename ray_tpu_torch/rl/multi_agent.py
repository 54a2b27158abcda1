"""Multi-agent RL: policy→agent mapping over vectorized env runners.

Counterpart of ``ray_tpu/rl/multi_agent.py``. Reference:
``rllib/env/multi_agent_env.py`` + ``rllib/policy/`` policy mapping
[UNVERIFIED — mount empty, SURVEY.md §0]: several agents step one
environment, each agent's experience routed to the policy chosen by
``policy_mapping_fn``; every policy learns from its own stream.

Learner shape: all policies' params and optimizer state are STACKED along
a leading policy axis and updated together — ``ppo.ppo_update``, the
single-policy update, run under ``torch.func.vmap`` over that axis (the
reference ``jax.vmap``s its per-policy update inside one jit), on the
learner's device in the driver. The reference's ``dp`` mesh spans every
local chip, lowered until it divides B (runners x envs x the most agents
a policy has); the port's learner count is the same (every local card on
``"cuda"``, 1 on ``"cpu"``), and above one the update runs on a gang of
ranks (``ppo.DPUpdate``), each with its columns of B, as
``ppo.ppo_update_dp(stacked=True)``: per-policy advantage moments summed
over ``dp``, per-policy gradients averaged over it. P policies, one batched set of launches;
no per-policy dispatch, no Python loop over policies on the hot path
(policies share a network shape, the standard stacked-policy layout).
"""

from __future__ import annotations

import pickle
import time
from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rl.config import AlgorithmConfigBase
from ray_tpu_torch.rl.ppo import (
    DPUpdate, init_policy_params, learner_count, ppo_hyper, ppo_update,
    ppo_update_dp, to_device, to_numpy)


# --------------------------------------------------------------------------
# Multi-agent vectorized environments
# --------------------------------------------------------------------------

class MultiAgentVectorEnv:
    """Batch of multi-agent environments advanced together.

    Subclasses define ``agent_ids``, ``obs_dim``, ``num_actions``,
    ``_reset_rows`` and ``_physics``. All agents step simultaneously
    (simultaneous-move games); done rows auto-reset.
    """

    agent_ids: Tuple[str, ...] = ()
    obs_dim: int = 0
    num_actions: int = 0

    def __init__(self, num_envs: int, seed: int = 0):
        self.num_envs = num_envs
        self.rng = np.random.RandomState(seed)
        self.episode_len = np.zeros(num_envs, np.int32)
        self.episode_return = {a: np.zeros(num_envs, np.float32)
                               for a in self.agent_ids}
        self.completed_returns: Dict[str, list] = {a: []
                                                   for a in self.agent_ids}
        self._reset_rows(np.arange(num_envs))

    def observe(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def step(self, actions: Dict[str, np.ndarray]
             ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray],
                        np.ndarray]:
        rewards, done = self._physics(actions)
        self.episode_len += 1
        for a in self.agent_ids:
            self.episode_return[a] += rewards[a]
        rows = np.nonzero(done)[0]
        if len(rows):
            for a in self.agent_ids:
                self.completed_returns[a].extend(
                    self.episode_return[a][rows].tolist())
                self.episode_return[a][rows] = 0.0
            self.episode_len[rows] = 0
            self._reset_rows(rows)
        return self.observe(), rewards, done

    def drain_episode_returns(self) -> Dict[str, list]:
        out = self.completed_returns
        self.completed_returns = {a: [] for a in self.agent_ids}
        return out

    # -- subclass API ---------------------------------------------------

    def _reset_rows(self, rows: np.ndarray) -> None:
        raise NotImplementedError

    def _physics(self, actions: Dict[str, np.ndarray]
                 ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        raise NotImplementedError


class TwoTargetsEnv(MultiAgentVectorEnv):
    """Two agents see the SAME one-hot context but have DIFFERENT
    optimal actions (alice: the context class; bob: the class shifted
    by one). A single shared policy cannot satisfy both — per-policy
    learning through the mapping is what makes the reward reachable,
    which is exactly what the learning test asserts."""

    agent_ids = ("alice", "bob")
    obs_dim = 4
    num_actions = 4
    EP_LEN = 8

    def __init__(self, num_envs: int, seed: int = 0):
        self.context = np.zeros(num_envs, np.int64)
        super().__init__(num_envs, seed)

    def _reset_rows(self, rows: np.ndarray) -> None:
        self.context[rows] = self.rng.randint(0, self.obs_dim, len(rows))

    def observe(self) -> Dict[str, np.ndarray]:
        onehot = np.eye(self.obs_dim, dtype=np.float32)[self.context]
        return {a: onehot.copy() for a in self.agent_ids}

    def _physics(self, actions: Dict[str, np.ndarray]
                 ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        r_alice = (actions["alice"] == self.context).astype(np.float32)
        r_bob = (actions["bob"]
                 == (self.context + 1) % self.num_actions).astype(
                     np.float32)
        # fresh context every step (contextual-bandit-style episodes)
        self.context = self.rng.randint(0, self.obs_dim, self.num_envs)
        done = self.episode_len + 1 >= self.EP_LEN
        return {"alice": r_alice, "bob": r_bob}, done


_MA_ENV_REGISTRY: Dict[str, type] = {"TwoTargets": TwoTargetsEnv}


def register_multi_agent_env(name: str, cls: type) -> None:
    _MA_ENV_REGISTRY[name] = cls


def make_multi_agent_env(name: str, num_envs: int,
                         seed: int = 0) -> MultiAgentVectorEnv:
    if name not in _MA_ENV_REGISTRY:
        raise ValueError(f"unknown multi-agent env {name!r}; known: "
                         f"{sorted(_MA_ENV_REGISTRY)}")
    return _MA_ENV_REGISTRY[name](num_envs, seed)


# --------------------------------------------------------------------------
# Runner actors
# --------------------------------------------------------------------------

def _np_forward(params: Dict[str, np.ndarray], obs: np.ndarray
                ) -> np.ndarray:
    h = np.tanh(obs @ params["w1"] + params["b1"])
    h = np.tanh(h @ params["w2"] + params["b2"])
    return h @ params["wp"] + params["bp"]


class MultiAgentEnvRunner:
    """Actor: steps a multi-agent vector env, sampling each agent's
    actions from the policy its ``policy_mapping_fn`` names."""

    def __init__(self, env_name: str, num_envs: int,
                 mapping_blob: bytes, seed: int = 0):
        import cloudpickle
        self.env = make_multi_agent_env(env_name, num_envs, seed)
        self.mapping: Callable[[str], str] = cloudpickle.loads(
            mapping_blob)
        self.rng = np.random.RandomState(seed + 20_000)
        self.obs = self.env.observe()

    def collect(self, policy_params: Dict[str, Dict[str, np.ndarray]],
                rollout_len: int) -> Dict[str, Dict[str, np.ndarray]]:
        """Per-AGENT fixed-length trajectories, keyed by agent id
        (the algorithm groups them by mapped policy)."""
        env = self.env
        T, B = rollout_len, env.num_envs
        bufs = {a: {"obs": np.empty((T, B, env.obs_dim), np.float32),
                    "actions": np.empty((T, B), np.int32),
                    "logp": np.empty((T, B), np.float32),
                    "rewards": np.empty((T, B), np.float32),
                    "dones": np.empty((T, B), bool)}
                for a in env.agent_ids}
        for t in range(T):
            actions = {}
            for a in env.agent_ids:
                params = policy_params[self.mapping(a)]
                logits = _np_forward(params, self.obs[a])
                z = logits - logits.max(axis=1, keepdims=True)
                probs = np.exp(z)
                probs /= probs.sum(axis=1, keepdims=True)
                gumbel = -np.log(-np.log(
                    self.rng.uniform(1e-9, 1.0, logits.shape)))
                act = np.argmax(logits + gumbel, axis=1).astype(np.int32)
                bufs[a]["obs"][t] = self.obs[a]
                bufs[a]["actions"][t] = act
                bufs[a]["logp"][t] = np.log(
                    probs[np.arange(B), act] + 1e-9).astype(np.float32)
                actions[a] = act
            self.obs, rewards, done = env.step(actions)
            for a in env.agent_ids:
                bufs[a]["rewards"][t] = rewards[a]
                bufs[a]["dones"][t] = done
        for a in env.agent_ids:
            bufs[a]["last_obs"] = self.obs[a].copy()
        bufs["__returns__"] = {
            a: np.asarray(v, np.float32)
            for a, v in env.drain_episode_returns().items()}
        return bufs


# --------------------------------------------------------------------------
# The algorithm
# --------------------------------------------------------------------------

@dataclass
class MultiAgentPPOConfig(AlgorithmConfigBase):
    env: str = "TwoTargets"
    num_env_runners: int = 2
    num_envs_per_runner: int = 16
    rollout_length: int = 32
    lr: float = 1e-2
    gamma: float = 0.6
    lam: float = 0.9
    clip: float = 0.2
    epochs: int = 6
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.003
    hidden: int = 32
    seed: int = 0
    # policy table + agent->policy mapping (default: one policy per
    # agent id, mapped by identity — the reference's policy mapping)
    policies: Optional[List[str]] = None
    policy_mapping_fn: Optional[Callable[[str], str]] = None
    device: str = "cuda"            # the learner's device

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO(self)


def make_dp_update(config: MultiAgentPPOConfig, n: int, device="cuda",
                   ranks=None) -> DPUpdate:
    """The stacked update over a gang of ``n`` ranks (``ranks``, or new
    ones), with ``make_update``'s signature (B is axis 2 of the batch,
    axis 1 of ``last_obs``); ``close()`` stops new ranks."""
    return DPUpdate(ppo_update_dp, {**ppo_hyper(config), "stacked": True},
                    n, device, lead=1, outputs=3, ranks=ranks)


def make_update(config: MultiAgentPPOConfig, device="cuda",
                learners: int = 1):
    """The stacked update on ``device`` as a function of numpy arrays, with
    the signature of the reference's jitted update: (params, m, v, obs,
    actions, old_logp, rewards, dones, last_obs, t0) -> (params, m, v),
    every leaf with the policy axis in front. ``learners`` above 1:
    ``make_dp_update``."""
    import torch
    if learners > 1:
        return make_dp_update(config, learners, device)
    dev = resolve_device(device)
    one_policy_update = partial(ppo_update, **ppo_hyper(config))
    stacked = torch.func.vmap(one_policy_update, in_dims=(0,) * 9 + (None,))

    def update(params, m, v, obs, actions, old_logp, rewards, dones,
               last_obs, t0):
        args = to_device((params, m, v, obs, actions, old_logp, rewards,
                          dones, last_obs), dev)
        params, m, v, _ = stacked(*args, int(t0))
        return to_numpy((params, m, v))

    return update


class MultiAgentPPO:
    """Multi-agent PPO: per-policy learner state stacked on a leading
    axis, updated together by the vmapped single-policy update."""

    def __init__(self, config: MultiAgentPPOConfig):
        import cloudpickle
        import torch
        self.config = config
        self.device = resolve_device(config.device)
        rt.init()
        probe = make_multi_agent_env(config.env, 1, 0)
        self.agent_ids = probe.agent_ids
        self.obs_dim = probe.obs_dim
        self.num_actions = probe.num_actions
        self.mapping = (config.policy_mapping_fn
                        or (lambda agent_id: agent_id))
        self.policies = list(config.policies
                             or sorted({self.mapping(a)
                                        for a in self.agent_ids}))
        unmapped = {a: self.mapping(a) for a in self.agent_ids
                    if self.mapping(a) not in self.policies}
        if unmapped:
            raise ValueError(
                f"policy_mapping_fn maps {unmapped} outside the policy "
                f"table {self.policies}; list every mapped policy in "
                "`policies` (or omit it to derive from the mapping)")
        self._policy_index = {p: i for i, p in enumerate(self.policies)}

        mapping_blob = cloudpickle.dumps(self.mapping)
        runner_cls = rt.remote(MultiAgentEnvRunner)
        self.runners = [
            runner_cls.options(num_cpus=1).remote(
                config.env, config.num_envs_per_runner, mapping_blob,
                config.seed + 1000 * i)
            for i in range(config.num_env_runners)]

        # stacked params: leaf shape [P, ...] — one dict, P policies
        gen = torch.Generator().manual_seed(config.seed)
        per_policy = [init_policy_params(gen, self.obs_dim,
                                         self.num_actions, config.hidden)
                      for _ in self.policies]
        self.params = {k: np.stack([p[k] for p in per_policy])
                       for k in per_policy[0]}
        self.opt_m = {k: np.zeros_like(v) for k, v in self.params.items()}
        self.opt_v = {k: np.zeros_like(v) for k, v in self.params.items()}

        self.learners = learner_count(
            self.device, None, config.num_env_runners
            * config.num_envs_per_runner * self._agents_per_policy_max())
        self._update = make_update(config, self.device, self.learners)
        # the learner gang, when there is one: stop() closes it
        self._gang = self._update if self.learners > 1 else None
        self.iteration = 0
        self._step_count = 0
        self._recent: Dict[str, List[float]] = {p: []
                                                for p in self.policies}

    def _agents_per_policy_max(self) -> int:
        counts: Dict[str, int] = {}
        for a in self.agent_ids:
            counts[self.mapping(a)] = counts.get(self.mapping(a), 0) + 1
        return max(counts.values())

    # -- Trainable API --------------------------------------------------

    def train(self) -> Dict:
        cfg = self.config
        t_start = time.perf_counter()
        params_by_policy = {
            p: {k: v[i] for k, v in self.params.items()}
            for p, i in self._policy_index.items()}
        rollouts = rt.get(
            [r.collect.remote(params_by_policy, cfg.rollout_length)
             for r in self.runners], timeout=300)

        # group per-agent trajectories by mapped policy, concat on B,
        # then stack policies on the leading axis
        grouped: Dict[str, Dict[str, list]] = {
            p: {k: [] for k in ("obs", "actions", "logp", "rewards",
                                "dones", "last_obs")}
            for p in self.policies}
        for ro in rollouts:
            for a in self.agent_ids:
                pol = self.mapping(a)
                for k in ("obs", "actions", "logp", "rewards", "dones"):
                    grouped[pol][k].append(ro[a][k])
                grouped[pol]["last_obs"].append(ro[a]["last_obs"])
            for a, rets in ro["__returns__"].items():
                self._recent[self.mapping(a)].extend(rets.tolist())
        for p in self.policies:
            self._recent[p] = self._recent[p][-200:]

        def stack(key, axis):
            per_pol = [np.concatenate(grouped[p][key], axis=axis)
                       for p in self.policies]
            sizes = {x.shape for x in per_pol}
            if len(sizes) > 1:
                raise ValueError(
                    "policies received unequal batch shapes "
                    f"{sizes}; map equal numbers of agents per policy")
            return np.stack(per_pol)

        obs = stack("obs", 1)
        actions = stack("actions", 1)
        logp = stack("logp", 1)
        rewards = stack("rewards", 1)
        dones = stack("dones", 1)
        last_obs = stack("last_obs", 0)

        self.params, self.opt_m, self.opt_v = self._update(
            self.params, self.opt_m, self.opt_v, obs, actions, logp,
            rewards, dones, last_obs, self._step_count)
        self._step_count += cfg.epochs
        self.iteration += 1

        returns = {p: (float(np.mean(self._recent[p]))
                       if self._recent[p] else 0.0)
                   for p in self.policies}
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": float(np.mean(list(returns.values()))),
            "policy_return_means": returns,
            "time_this_iter_s": time.perf_counter() - t_start,
        }

    # -- checkpointing --------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump({"params": self.params, "m": self.opt_m,
                         "v": self.opt_v, "iteration": self.iteration,
                         "step_count": self._step_count,
                         "policies": self.policies}, f)

    def restore(self, path: str) -> None:
        with open(path, "rb") as f:
            st = pickle.load(f)
        assert st["policies"] == self.policies, "policy table changed"
        self.params, self.opt_m, self.opt_v = (st["params"], st["m"],
                                               st["v"])
        self.iteration = st["iteration"]
        self._step_count = st["step_count"]

    def stop(self) -> None:
        if self._gang is not None:
            self._gang.close()
        for r in self.runners:
            try:
                rt.kill(r)
            except Exception:
                pass    # runner already dead
