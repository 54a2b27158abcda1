"""The RLlib-style learning tests of the JAX package's ``tests/test_rl.py``
on the port: PPO and DQN must lift CartPole returns to the reference's
thresholds within its budgets (PPO ``best >= 120`` in 30 iterations, DQN
``>= 60`` in 25), with the reference's seeds and settings, the learner on
the CPU (``device="cpu"``).

Each starts from the JAX package's initial parameters for its seed (and
DQN from optax's initial Adam state), carried across as numpy through
``restore``, since ``jax.random`` cannot be reproduced in torch."""

import os
import pickle
import tempfile

import numpy as np
import pytest

import ray_tpu_torch as rt


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    import torch
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def ray_start_regular():
    w = rt.init(num_cpus=4, num_gpus=8, max_process_workers=2)
    yield w
    rt.shutdown()


def restore_from(algo, state):
    """``algo.restore`` of ``state`` through a checkpoint file."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "init.pkl")
        with open(path, "wb") as f:
            pickle.dump(state, f)
        algo.restore(path)


def test_ppo_learns_cartpole(ray_start_regular):
    """PPO must lift CartPole returns well above the random-policy
    baseline within a bounded budget."""
    import jax
    from ray_tpu.rl import ppo as jppo
    from ray_tpu_torch.rl import PPOConfig
    algo = (PPOConfig()
            .environment("CartPole")
            .env_runners(num_env_runners=2, num_envs_per_runner=16,
                         rollout_length=128)
            .training(lr=3e-3, epochs=10, entropy_coeff=0.01, seed=1,
                      device="cpu")
            .build())
    try:
        params = jax.tree.map(np.asarray, jppo.init_policy_params(
            jax.random.PRNGKey(1), 4, 2, 64))
        restore_from(algo, {
            "params": params,
            "opt_m": {k: np.zeros_like(x) for k, x in params.items()},
            "opt_v": {k: np.zeros_like(x) for k, x in params.items()},
            "iteration": 0, "step_count": 0})
        first = algo.train()
        assert first["training_iteration"] == 1
        best = 0.0
        for _ in range(30):
            result = algo.train()
            best = max(best, result["episode_return_mean"])
            if best >= 120.0:
                break
        assert best >= 120.0, f"PPO failed to learn: best={best}"
        # checkpoint round-trip preserves the learned policy
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "ckpt.pkl")
            algo.save(path)
            it = algo.iteration
            algo.restore(path)
            assert algo.iteration == it
    finally:
        algo.stop()


def test_dqn_learns_cartpole(ray_start_regular):
    """Second algorithm family (value-based, replay buffer, target
    network): DQN improves CartPole returns within a bounded budget."""
    import jax
    import optax
    from ray_tpu.rl import dqn as jdqn
    from ray_tpu_torch.models.convert import adam_state_from_optax
    from ray_tpu_torch.rl import DQNConfig
    algo = (DQNConfig()
            .environment("CartPole")
            .env_runners(num_env_runners=2, num_envs_per_runner=8,
                         rollout_length=64)
            .training(lr=1e-3, updates_per_iteration=64,
                      eps_decay_iters=10, train_batch_size=128,
                      device="cpu")
            .build())
    try:
        params = jax.tree.map(np.asarray, jdqn.init_q_params(
            jax.random.PRNGKey(0), 4, 2, 64))
        opt_state = jax.tree.map(np.asarray, optax.adam(1e-3).init(params))
        restore_from(algo, {
            "params": params,
            "target": {k: x.copy() for k, x in params.items()},
            "opt_state": adam_state_from_optax(opt_state),
            "iteration": 0, "buffer": None, "rng": None})
        best = -np.inf
        first = None
        for _ in range(25):
            metrics = algo.train()
            ret = metrics["episode_return_mean"]
            if np.isfinite(ret):
                if first is None:
                    first = ret
                best = max(best, ret)
            if best >= 60:
                break
        assert first is not None
        assert best >= 60, (first, best)
        # checkpoint round trip (path API, matches PPO) restores the
        # full off-policy state: params, target, optimizer, buffer, rng
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "ckpt.pkl")
            algo.save(path)
            buf_len = len(algo.buffer)
            count = int(algo.opt_state["count"])
            algo.restore(path)
            assert algo.iteration > 0 and len(algo.buffer) == buf_len
            assert int(algo.opt_state["count"]) == count > 0
    finally:
        algo.stop()
