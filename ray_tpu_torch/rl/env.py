"""Vectorized environments for the RL layer (a copy of
``ray_tpu/rl/env.py``).

Reference: RLlib steps gym envs inside EnvRunner actors, vectorized
per runner (``rllib/env/``) [UNVERIFIED — mount empty, SURVEY.md §0].
Here envs are batch-vectorized numpy from the start — one runner steps
``num_envs`` environments as array ops, the natural shape for feeding
a device learner.
"""

from __future__ import annotations

from typing import Dict, Tuple, Type

import numpy as np


class VectorEnv:
    """Batch of environments advanced together. Auto-resets done envs.

    Subclasses define: ``obs_dim``, ``num_actions``, ``_reset_rows``,
    ``_physics``.
    """

    obs_dim: int = 0
    num_actions: int = 0

    def __init__(self, num_envs: int, seed: int = 0):
        self.num_envs = num_envs
        self.rng = np.random.RandomState(seed)
        self.state = np.zeros((num_envs, self.obs_dim), np.float32)
        self.episode_return = np.zeros(num_envs, np.float32)
        self.episode_len = np.zeros(num_envs, np.int32)
        self.completed_returns: list = []
        self._reset_rows(np.arange(num_envs))

    def observe(self) -> np.ndarray:
        return self.state.copy()

    def step(self, actions: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(obs, reward, done) for the batch; done rows auto-reset (the
        returned obs is the POST-reset observation, gym vec-env style).
        """
        reward, done = self._physics(actions)
        self.episode_return += reward
        self.episode_len += 1
        done_rows = np.nonzero(done)[0]
        if len(done_rows):
            self.completed_returns.extend(
                self.episode_return[done_rows].tolist())
            self.episode_return[done_rows] = 0.0
            self.episode_len[done_rows] = 0
            self._reset_rows(done_rows)
        return self.observe(), reward, done

    def drain_episode_returns(self) -> list:
        out = self.completed_returns
        self.completed_returns = []
        return out

    # -- subclass API --------------------------------------------------

    def _reset_rows(self, rows: np.ndarray) -> None:
        raise NotImplementedError

    def _physics(self, actions: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError


class CartPoleVec(VectorEnv):
    """Classic CartPole-v1 dynamics, batch-vectorized.

    State: [x, x_dot, theta, theta_dot]; actions {0: left, 1: right};
    reward 1 per step; terminates at |x| > 2.4, |theta| > 12deg, or
    500 steps.
    """

    obs_dim = 4
    num_actions = 2

    GRAVITY = 9.8
    CART_MASS = 1.0
    POLE_MASS = 0.1
    POLE_HALF_LEN = 0.5
    FORCE = 10.0
    DT = 0.02
    X_LIMIT = 2.4
    THETA_LIMIT = 12 * np.pi / 180
    MAX_STEPS = 500

    def _reset_rows(self, rows: np.ndarray) -> None:
        self.state[rows] = self.rng.uniform(
            -0.05, 0.05, (len(rows), 4)).astype(np.float32)

    def _physics(self, actions: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        x, x_dot, th, th_dot = self.state.T
        force = np.where(actions == 1, self.FORCE, -self.FORCE)
        total_mass = self.CART_MASS + self.POLE_MASS
        pm_l = self.POLE_MASS * self.POLE_HALF_LEN
        cos_t, sin_t = np.cos(th), np.sin(th)
        temp = (force + pm_l * th_dot ** 2 * sin_t) / total_mass
        th_acc = (self.GRAVITY * sin_t - cos_t * temp) / (
            self.POLE_HALF_LEN * (4.0 / 3.0
                                  - self.POLE_MASS * cos_t ** 2 / total_mass))
        x_acc = temp - pm_l * th_acc * cos_t / total_mass
        x = x + self.DT * x_dot
        x_dot = x_dot + self.DT * x_acc
        th = th + self.DT * th_dot
        th_dot = th_dot + self.DT * th_acc
        self.state = np.stack([x, x_dot, th, th_dot], axis=1).astype(
            np.float32)
        done = ((np.abs(x) > self.X_LIMIT)
                | (np.abs(th) > self.THETA_LIMIT)
                | (self.episode_len + 1 >= self.MAX_STEPS))
        reward = np.ones(self.num_envs, np.float32)
        return reward, done


_ENV_REGISTRY: Dict[str, Type[VectorEnv]] = {
    "CartPole": CartPoleVec,
}


def register_env(name: str, cls: Type[VectorEnv]) -> None:
    _ENV_REGISTRY[name] = cls


def make_env(name: str, num_envs: int, seed: int = 0) -> VectorEnv:
    if name not in _ENV_REGISTRY:
        raise ValueError(f"unknown env {name!r}; known: "
                         f"{sorted(_ENV_REGISTRY)}")
    return _ENV_REGISTRY[name](num_envs, seed)
