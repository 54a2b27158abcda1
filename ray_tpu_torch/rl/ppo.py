"""PPO: CPU rollout actors + a torch learner on the card.

Counterpart of ``ray_tpu/rl/ppo.py``. Reference: ``rllib/algorithms/ppo/``
driving an EnvRunnerGroup and a LearnerGroup (DDP learner actors)
[UNVERIFIED — mount empty, SURVEY.md §0]. The port's shape:

- experience collection stays on cheap CPU actors (numpy inference),
- the learner runs in the driver (the process that owns the card) as
  plain torch on the learner's device: GAE as a Python loop over T (the
  reference's reverse ``lax.scan``), advantage normalisation, the
  clipped-surrogate epochs as a loop of gradient steps
  (``torch.func.grad_and_value``), Adam written out. The reference jits
  one program over a ``dp`` mesh of every local chip; the port's learner
  runs on one device with no mesh and no process group, and refuses
  ``learner_devices > 1``.

Resource gang: a placement group reserves one CPU bundle per runner
plus a learner bundle (GPU when available) — RLlib's heterogeneous
rollout/learner shape via gang scheduling.

Torch is imported inside the functions that use it: runner actors import
this package in process workers, which must not pay torch's import.
"""

from __future__ import annotations

import pickle
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rl.config import AlgorithmConfigBase
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.env_runner import EnvRunnerGroup


# --------------------------------------------------------------------------
# policy/value network


def init_policy_params(generator, obs_dim: int, num_actions: int,
                       hidden: int = 64) -> Dict[str, np.ndarray]:
    """The policy/value parameters as fp32 numpy arrays, drawn from the
    CPU ``torch.Generator`` ``generator`` (the reference's keys k1..k6 in
    order: w1, w2, wp, vw1, vw2, wv)."""
    import torch

    def dense(fan_in, shape):
        return np.asarray(torch.randn(shape, generator=generator).numpy()
                          / np.sqrt(fan_in), np.float32)

    # Separate policy/value trunks: the value target scale (episode
    # returns, O(100)) would otherwise swamp the policy gradient
    # through a shared trunk.
    return {
        "w1": dense(obs_dim, (obs_dim, hidden)),
        "b1": np.zeros(hidden, np.float32),
        "w2": dense(hidden, (hidden, hidden)),
        "b2": np.zeros(hidden, np.float32),
        "wp": dense(hidden, (hidden, num_actions)) * 0.01,
        "bp": np.zeros(num_actions, np.float32),
        "vw1": dense(obs_dim, (obs_dim, hidden)),
        "vb1": np.zeros(hidden, np.float32),
        "vw2": dense(hidden, (hidden, hidden)),
        "vb2": np.zeros(hidden, np.float32),
        "wv": dense(hidden, (hidden, 1)) * 0.1,
        "bv": np.zeros(1, np.float32),
    }


def _net(params, obs):
    import torch
    h = torch.tanh(obs @ params["w1"] + params["b1"])
    h = torch.tanh(h @ params["w2"] + params["b2"])
    logits = h @ params["wp"] + params["bp"]
    hv = torch.tanh(obs @ params["vw1"] + params["vb1"])
    hv = torch.tanh(hv @ params["vw2"] + params["vb2"])
    value = (hv @ params["wv"] + params["bv"])[..., 0]
    return logits, value


def _log_probs(logits, actions):
    """(log-softmax over the actions, the log-prob of ``actions``)."""
    import torch
    logp_all = torch.log_softmax(logits, dim=-1)
    return logp_all, torch.gather(logp_all, -1, actions[..., None])[..., 0]


def _entropy(logp_all):
    import torch
    return -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))


# --------------------------------------------------------------------------
# the learner: plain torch functions on the learner's device


def adam(p, m, v, g, t: int, lr: float):
    """One Adam step at step count ``t`` (from 1) on dicts of tensors:
    b1 0.9, b2 0.999, eps 1e-8, the bias terms (1 - b**t) in fp32."""
    import torch
    b1, b2, eps = 0.9, 0.999, 1e-8
    c1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
    c2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))
    m = {k: b1 * m[k] + (1 - b1) * g[k] for k in m}
    v = {k: b2 * v[k] + (1 - b2) * g[k] ** 2 for k in v}
    p = {k: p[k] - lr * (m[k] / c1) / (torch.sqrt(v[k] / c2) + eps)
         for k in p}
    return p, m, v


def gae(rewards, values, last_v, not_done, gamma: float, lam: float):
    """GAE advantages [T, B] by the reverse recursion over T."""
    import torch
    adv_next, v_next = torch.zeros_like(last_v), last_v
    advs = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        delta = rewards[t] + gamma * v_next * not_done[t] - values[t]
        adv_next = delta + gamma * lam * not_done[t] * adv_next
        v_next = values[t]
        advs[t] = adv_next
    return torch.stack(advs)


def _ppo_loss(params, obs, actions, old_logp, adv, ret, clip, vf_coeff,
              entropy_coeff):
    import torch
    logits, value = _net(params, obs)
    logp_all, logp = _log_probs(logits, actions)
    ratio = torch.exp(logp - old_logp)
    clipped = torch.clamp(ratio, 1 - clip, 1 + clip)
    pg_loss = -torch.mean(torch.minimum(ratio * adv, clipped * adv))
    vf_loss = torch.mean((value - ret) ** 2)
    return pg_loss + vf_coeff * vf_loss - entropy_coeff * _entropy(logp_all)


def ppo_update(params, opt_m, opt_v, obs, actions, old_logp, rewards,
               dones, last_obs, t0: int, *, lr, gamma, lam, clip, epochs,
               vf_coeff, entropy_coeff):
    """The reference's jitted update on tensors: GAE from the current
    values, normalised advantages, ``epochs`` Adam steps of the clipped
    surrogate at steps ``t0 + 1 .. t0 + epochs``. Returns (params, m, v,
    the last epoch's loss). Pure, so ``torch.func.vmap`` can stack it over
    policies."""
    import torch
    actions = actions.long()
    _, values = _net(params, obs)                    # [T, B]
    _, last_v = _net(params, last_obs)               # [B]
    not_done = 1.0 - dones.float()
    adv = gae(rewards, values, last_v, not_done, gamma, lam)
    ret = adv + values
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    step = torch.func.grad_and_value(_ppo_loss)
    loss = None
    for t in range(epochs):
        grads, loss = step(params, obs, actions, old_logp, adv, ret, clip,
                           vf_coeff, entropy_coeff)
        params, opt_m, opt_v = adam(params, opt_m, opt_v, grads,
                                    t0 + t + 1, lr)
    return params, opt_m, opt_v, loss


def to_device(tree, device):
    """Numpy arrays (in dicts, lists and tuples) as tensors on
    ``device``."""
    import torch
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return torch.tensor(np.asarray(tree), device=device)


def to_numpy(tree):
    """Tensors (in dicts, lists and tuples) as numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()


def learner_device(device, learner_devices: Optional[int] = None):
    """The learner's ``torch.device``. The port's learner runs on one
    device: ``learner_devices`` above 1 is refused."""
    if learner_devices is not None and learner_devices > 1:
        raise ValueError(
            f"learner_devices={learner_devices}: the learner runs on one "
            "device; a learner over several cards is not supported")
    return resolve_device(device)


def make_update(config: "PPOConfig", device="cuda"):
    """The update on ``device`` as a function of numpy arrays, with the
    signature of the reference's jitted update: (params, opt_m, opt_v,
    obs, actions, old_logp, rewards, dones, last_obs, t0) -> (params,
    opt_m, opt_v, loss), all numpy."""
    dev = resolve_device(device)
    hyper = dict(lr=config.lr, gamma=config.gamma, lam=config.lam,
                 clip=config.clip, epochs=config.epochs,
                 vf_coeff=config.vf_coeff,
                 entropy_coeff=config.entropy_coeff)

    def update(params, opt_m, opt_v, obs, actions, old_logp, rewards,
               dones, last_obs, t0):
        args = to_device((params, opt_m, opt_v, obs, actions, old_logp,
                          rewards, dones, last_obs), dev)
        return to_numpy(ppo_update(*args, int(t0), **hyper))

    return update


# --------------------------------------------------------------------------
# config (AlgorithmConfig builder style)


@dataclass
class PPOConfig(AlgorithmConfigBase):
    env: str = "CartPole"
    num_env_runners: int = 2
    num_envs_per_runner: int = 16
    rollout_length: int = 128
    lr: float = 3e-3
    gamma: float = 0.99
    lam: float = 0.95
    clip: float = 0.2
    epochs: int = 8
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    hidden: int = 64
    seed: int = 0
    learner_devices: Optional[int] = None   # None or 1: one device
    use_placement_group: bool = True
    learner_resources: Dict[str, float] = field(default_factory=dict)
    device: str = "cuda"                    # the learner's device

    def resources(self, *, learner_devices: Optional[int] = None,
                  use_placement_group: Optional[bool] = None,
                  learner_resources: Optional[Dict[str, float]] = None
                  ) -> "PPOConfig":
        if learner_devices is not None:
            self.learner_devices = learner_devices
        if use_placement_group is not None:
            self.use_placement_group = use_placement_group
        if learner_resources is not None:
            self.learner_resources = dict(learner_resources)
        return self

    def build(self) -> "PPO":
        return PPO(self)


# --------------------------------------------------------------------------
# the algorithm


class PPO:
    """Iterative trainer: ``train()`` = collect + one learner update.

    Tune-compatible: train() returns a metrics dict; save()/restore()
    round-trip params + optimizer state.
    """

    def __init__(self, config: PPOConfig):
        import torch
        self.config = config
        self.device = learner_device(config.device, config.learner_devices)
        rt.init()
        probe = make_env(config.env, 1, 0)
        self.obs_dim = probe.obs_dim
        self.num_actions = probe.num_actions

        self._pg = None
        bundle_offset = 0
        if config.use_placement_group:
            from ray_tpu_torch.util.placement_group import placement_group
            learner_bundle = dict(config.learner_resources) or \
                self._default_learner_bundle()
            bundles = [learner_bundle] + \
                [{"CPU": 1.0}] * config.num_env_runners
            self._pg = placement_group(bundles, strategy="PACK")
            rt.get(self._pg.ready(), timeout=120)
            bundle_offset = 1
        self.runners = EnvRunnerGroup(
            config.env, config.num_env_runners, config.num_envs_per_runner,
            seed=config.seed, placement_group=self._pg,
            bundle_offset=bundle_offset)

        self.params = init_policy_params(
            torch.Generator().manual_seed(config.seed), self.obs_dim,
            self.num_actions, config.hidden)
        self.opt_state = {k: np.zeros_like(v)
                          for k, v in self.params.items()}  # adam m
        self.opt_state_v = {k: np.zeros_like(v)
                            for k, v in self.params.items()}  # adam v
        self.iteration = 0
        self._step_count = 0
        self._update = make_update(config, self.device)
        self._recent_returns: List[float] = []

    @staticmethod
    def _default_learner_bundle() -> Dict[str, float]:
        try:
            avail = rt.cluster_resources()
        except Exception:
            avail = {}
        if avail.get("GPU", 0) >= 1:
            return {"GPU": min(8.0, avail["GPU"]), "CPU": 1.0}
        return {"CPU": 1.0}

    # -- Trainable API -------------------------------------------------

    def train(self) -> Dict:
        cfg = self.config
        t_start = time.perf_counter()
        rollouts = self.runners.collect(self.params, cfg.rollout_length)
        obs = np.concatenate([r["obs"] for r in rollouts], axis=1)
        actions = np.concatenate([r["actions"] for r in rollouts], axis=1)
        logp = np.concatenate([r["logp"] for r in rollouts], axis=1)
        rewards = np.concatenate([r["rewards"] for r in rollouts], axis=1)
        dones = np.concatenate([r["dones"] for r in rollouts], axis=1)
        last_obs = np.concatenate([r["last_obs"] for r in rollouts], axis=0)
        for r in rollouts:
            self._recent_returns.extend(r["episode_returns"].tolist())
        self._recent_returns = self._recent_returns[-100:]

        (self.params, self.opt_state, self.opt_state_v,
         loss) = self._update(self.params, self.opt_state, self.opt_state_v,
                              obs, actions, logp, rewards, dones, last_obs,
                              self._step_count)
        self._step_count += cfg.epochs
        self.iteration += 1

        mean_ret = (float(np.mean(self._recent_returns))
                    if self._recent_returns else 0.0)
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": mean_ret,
            "num_env_steps_sampled": (self.iteration * cfg.rollout_length
                                      * cfg.num_env_runners
                                      * cfg.num_envs_per_runner),
            "loss": float(loss),
            "time_this_iter_s": time.perf_counter() - t_start,
        }

    # -- checkpointing -------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump({"params": self.params,
                         "opt_m": self.opt_state,
                         "opt_v": self.opt_state_v,
                         "iteration": self.iteration,
                         "step_count": self._step_count}, f)

    def restore(self, path: str) -> None:
        with open(path, "rb") as f:
            state = pickle.load(f)
        self.params = state["params"]
        self.opt_state = state["opt_m"]
        self.opt_state_v = state["opt_v"]
        self.iteration = state["iteration"]
        self._step_count = state["step_count"]

    def stop(self) -> None:
        self.runners.shutdown()
        if self._pg is not None:
            from ray_tpu_torch.util.placement_group import (
                remove_placement_group)
            try:
                remove_placement_group(self._pg)
            except Exception:
                pass    # group already removed with the cluster
