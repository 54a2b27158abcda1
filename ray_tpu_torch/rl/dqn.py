"""DQN: replay-buffer off-policy learning on the core API.

Counterpart of ``ray_tpu/rl/dqn.py``. Reference:
``rllib/algorithms/dqn/`` + ``rllib/utils/replay_buffers/`` [UNVERIFIED —
mount empty, SURVEY.md §0]. Same shape as ``ppo.py``: experience
collection on cheap CPU actors (epsilon-greedy over the Q-network), the
learner as plain torch on the card in the driver. Double-DQN targets
with a periodically-synced target network; the K gradient steps per
iteration run as a loop (the reference's ``lax.scan``), and the
reference's ``optax.adam`` is written out (``ppo.adam``: b1 0.9, b2
0.999, eps 1e-8, bias-corrected by the step count). The optimizer state
is the port's own: ``{"m", "v", "count"}`` as numpy
(``models.convert.adam_state_from_optax`` makes it from optax's).
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rl.config import AlgorithmConfigBase
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.env_runner import EnvRunnerGroup
from ray_tpu_torch.rl.ppo import adam, to_device, to_numpy


def init_q_params(generator, obs_dim: int, num_actions: int,
                  hidden: int = 64) -> Dict[str, np.ndarray]:
    """The Q-network's parameters as fp32 numpy arrays, drawn from the CPU
    ``torch.Generator`` ``generator`` (w1, w2, wp in order)."""
    import torch

    def dense(fan_in, shape):
        return np.asarray(torch.randn(shape, generator=generator).numpy()
                          / np.sqrt(fan_in), np.float32)

    return {
        "w1": dense(obs_dim, (obs_dim, hidden)),
        "b1": np.zeros(hidden, np.float32),
        "w2": dense(hidden, (hidden, hidden)),
        "b2": np.zeros(hidden, np.float32),
        # the runner's numpy mirror reads "wp"/"bp" as its action head
        "wp": dense(hidden, (hidden, num_actions)) * 0.01,
        "bp": np.zeros(num_actions, np.float32),
    }


def _q_net(params, obs):
    import torch
    h = torch.tanh(obs @ params["w1"] + params["b1"])
    h = torch.tanh(h @ params["w2"] + params["b2"])
    return h @ params["wp"] + params["bp"]


def init_adam_state(params: Dict[str, np.ndarray]) -> dict:
    """Zero moments and step count 0, as ``optax.adam(lr).init``."""
    return {"m": {k: np.zeros_like(v) for k, v in params.items()},
            "v": {k: np.zeros_like(v) for k, v in params.items()},
            "count": np.asarray(0, np.int32)}


def _td_loss(params, target_params, batch, gamma):
    import torch
    q = _q_net(params, batch["obs"])
    q_a = torch.gather(q, 1, batch["actions"][:, None])[:, 0]
    # double DQN: online net argmaxes, target net evaluates
    next_online = _q_net(params, batch["next_obs"])
    next_act = torch.argmax(next_online, dim=1)
    next_target = _q_net(target_params, batch["next_obs"])
    next_q = torch.gather(next_target, 1, next_act[:, None])[:, 0]
    target = batch["rewards"] + gamma * (
        1.0 - batch["dones"]) * next_q.detach()
    return torch.mean((q_a - target) ** 2)


def dqn_update(params, opt_state, target_params, batches, *, lr, gamma):
    """The reference's jitted update on tensors: one Adam step of the
    double-DQN TD loss for each of the K batches ([K, batch] leaves).
    Returns (params, opt_state, the K losses)."""
    import torch
    batches = dict(batches, actions=batches["actions"].long())
    m, v, count = opt_state["m"], opt_state["v"], int(opt_state["count"])
    step = torch.func.grad_and_value(_td_loss)
    losses = []
    for k in range(batches["obs"].shape[0]):
        grads, loss = step(params, target_params,
                           {key: val[k] for key, val in batches.items()},
                           gamma)
        count += 1
        params, m, v = adam(params, m, v, grads, count, lr)
        losses.append(loss)
    return params, {"m": m, "v": v, "count": count}, torch.stack(losses)


def make_update(config: "DQNConfig", device="cuda"):
    """The update on ``device`` as a function of numpy arrays, with the
    signature of the reference's jitted update: (params, opt_state,
    target_params, batches) -> (params, opt_state, losses)."""
    dev = resolve_device(device)

    def update(params, opt_state, target_params, batches):
        params, m, v, target, batches = to_device(
            (params, opt_state["m"], opt_state["v"], target_params,
             batches), dev)
        params, state, losses = dqn_update(
            params, {"m": m, "v": v, "count": int(opt_state["count"])},
            target, batches, lr=config.lr, gamma=config.gamma)
        return to_numpy(params), {
            "m": to_numpy(state["m"]), "v": to_numpy(state["v"]),
            "count": np.asarray(state["count"], np.int32)}, to_numpy(losses)

    return update


class ReplayBuffer:
    """Uniform FIFO replay over transition arrays (the reference's
    ReplayBuffer role, host-side numpy)."""

    def __init__(self, capacity: int, obs_dim: int):
        self.capacity = capacity
        self._obs = np.empty((capacity, obs_dim), np.float32)
        self._next_obs = np.empty((capacity, obs_dim), np.float32)
        self._act = np.empty(capacity, np.int32)
        self._rew = np.empty(capacity, np.float32)
        self._done = np.empty(capacity, np.float32)
        self._size = 0
        self._pos = 0

    def add_rollout(self, batch: Dict[str, np.ndarray]) -> None:
        """Flatten a [T, B] runner rollout into transitions. The next
        observation of step t is obs[t+1] (last step uses last_obs);
        done cuts the bootstrap."""
        obs, act = batch["obs"], batch["actions"]
        rew, done = batch["rewards"], batch["dones"]
        T, B = act.shape
        next_obs = np.concatenate([obs[1:], batch["last_obs"][None]], 0)
        flat = (obs.reshape(T * B, -1), next_obs.reshape(T * B, -1),
                act.reshape(-1), rew.reshape(-1),
                done.astype(np.float32).reshape(-1))
        n = T * B
        for i in range(0, n, self.capacity):
            self._insert(*(a[i:i + self.capacity] for a in flat))

    def _insert(self, obs, next_obs, act, rew, done) -> None:
        n = len(act)
        idx = (self._pos + np.arange(n)) % self.capacity
        self._obs[idx] = obs
        self._next_obs[idx] = next_obs
        self._act[idx] = act
        self._rew[idx] = rew
        self._done[idx] = done
        self._pos = int((self._pos + n) % self.capacity)
        self._size = int(min(self._size + n, self.capacity))

    def __len__(self) -> int:
        return self._size

    def sample(self, rng: np.random.RandomState, batch_size: int
               ) -> Dict[str, np.ndarray]:
        idx = rng.randint(0, self._size, batch_size)
        return {"obs": self._obs[idx], "next_obs": self._next_obs[idx],
                "actions": self._act[idx], "rewards": self._rew[idx],
                "dones": self._done[idx]}

    def sample_many(self, rng: np.random.RandomState, k: int,
                    batch_size: int) -> Dict[str, np.ndarray]:
        """[k, batch] of consistent transitions: ONE index matrix, one
        gather per key (k separate sample() calls would do k*5 fancy
        indexes + 5 stacks on the host hot path)."""
        idx = rng.randint(0, self._size, (k, batch_size))
        return {"obs": self._obs[idx], "next_obs": self._next_obs[idx],
                "actions": self._act[idx], "rewards": self._rew[idx],
                "dones": self._done[idx]}

    def state_dict(self) -> dict:
        n = self._size
        return {"obs": self._obs[:n].copy(),
                "next_obs": self._next_obs[:n].copy(),
                "act": self._act[:n].copy(),
                "rew": self._rew[:n].copy(),
                "done": self._done[:n].copy(),
                "pos": self._pos}

    def load_state_dict(self, state: dict) -> None:
        n = len(state["act"])
        self._obs[:n] = state["obs"]
        self._next_obs[:n] = state["next_obs"]
        self._act[:n] = state["act"]
        self._rew[:n] = state["rew"]
        self._done[:n] = state["done"]
        self._size = n
        self._pos = int(state["pos"]) % self.capacity


@dataclass
class DQNConfig(AlgorithmConfigBase):
    env: str = "CartPole"
    num_env_runners: int = 2
    num_envs_per_runner: int = 8
    rollout_length: int = 64
    lr: float = 1e-3
    gamma: float = 0.99
    buffer_capacity: int = 50_000
    train_batch_size: int = 128
    updates_per_iteration: int = 64
    target_sync_every: int = 4      # iterations between target syncs
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_iters: int = 20
    hidden: int = 64
    seed: int = 0
    device: str = "cuda"            # the learner's device

    def build(self) -> "DQN":
        return DQN(self)


class DQN:
    """Iterative trainer: ``train()`` = collect (epsilon-greedy) +
    replay-sampled double-DQN updates. Tune-compatible (train() returns
    metrics; save()/restore() round-trip state)."""

    def __init__(self, cfg: DQNConfig):
        import torch
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        probe = make_env(cfg.env, 1, cfg.seed)
        self._obs_dim = probe.obs_dim
        self._num_actions = probe.num_actions
        self.params = init_q_params(torch.Generator().manual_seed(cfg.seed),
                                    self._obs_dim, self._num_actions,
                                    cfg.hidden)
        self.target_params = {k: v.copy() for k, v in self.params.items()}
        self.buffer = ReplayBuffer(cfg.buffer_capacity, self._obs_dim)
        self.opt_state = init_adam_state(self.params)
        self._rng = np.random.RandomState(cfg.seed)
        self.iteration = 0
        self.runners = EnvRunnerGroup(cfg.env, cfg.num_env_runners,
                                      cfg.num_envs_per_runner, cfg.seed)
        self._update = make_update(cfg, self.device)

    def _epsilon(self) -> float:
        cfg = self.cfg
        frac = min(1.0, self.iteration / max(1, cfg.eps_decay_iters))
        return cfg.eps_start + frac * (cfg.eps_end - cfg.eps_start)

    def train(self) -> Dict[str, float]:
        cfg = self.cfg
        eps = self._epsilon()
        rollouts = self.runners.collect(self.params, cfg.rollout_length,
                                        explore_eps=eps)
        returns: List[float] = []
        for r in rollouts:
            self.buffer.add_rollout(r)
            returns.extend(r["episode_returns"].tolist())

        losses = []
        if len(self.buffer) >= cfg.train_batch_size:
            K = cfg.updates_per_iteration
            # one index matrix, one gather per key: [K, batch] of
            # CONSISTENT transitions (per-key sampling would pair
            # observations with unrelated actions/rewards)
            batches = self.buffer.sample_many(
                self._rng, K, cfg.train_batch_size)
            self.params, self.opt_state, loss_arr = self._update(
                self.params, self.opt_state, self.target_params, batches)
            losses = list(loss_arr)
        self.iteration += 1
        if self.iteration % cfg.target_sync_every == 0:
            self.target_params = {k: v.copy()
                                  for k, v in self.params.items()}
        return {
            "iteration": self.iteration,
            "epsilon": round(eps, 4),
            "episode_return_mean": (float(np.mean(returns))
                                    if returns else float("nan")),
            "num_episodes": len(returns),
            "buffer_size": len(self.buffer),
            "loss": float(np.mean(losses)) if losses else float("nan"),
        }

    # -- checkpointing (Tune-compatible, PPO-matching path API) --------

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump({
                "params": self.params, "target": self.target_params,
                "opt_state": self.opt_state,
                "iteration": self.iteration,
                # off-policy state: without the buffer + rng a restore
                # into a fresh process would resume with no replay data
                # at end-schedule epsilon and stall
                "buffer": self.buffer.state_dict(),
                "rng": self._rng.get_state()}, f)

    def restore(self, path: str) -> None:
        with open(path, "rb") as f:
            state = pickle.load(f)
        self.params = state["params"]
        self.target_params = state["target"]
        self.opt_state = state.get("opt_state") or init_adam_state(
            self.params)
        self.iteration = state["iteration"]
        if state.get("buffer") is not None:
            self.buffer.load_state_dict(state["buffer"])
        if state.get("rng") is not None:
            self._rng.set_state(state["rng"])

    def stop(self) -> None:
        self.runners.shutdown()
