"""The RL layer on the port: the vectorized env, the rollout actors, the
replay buffer and PPO's resource gang, the cases of the JAX package's
``tests/test_rl.py`` that need no learning run (those are in
``test_torch_rl_learning.py`` and ``test_torch_rl_multi_agent.py``), plus
the copies' parity with the reference: the env steps and a runner group's
rollouts equal the JAX package's on the same params and seeds. Runners are
CPU process workers; the learner runs on the CPU here
(``device="cpu"``)."""

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


def test_vector_env_semantics():
    from ray_tpu_torch.rl import CartPoleVec
    env = CartPoleVec(8, seed=0)
    obs = env.observe()
    assert obs.shape == (8, 4)
    total_done = 0
    for _ in range(300):
        obs, rew, done = env.step(np.random.randint(0, 2, 8))
        assert rew.shape == (8,)
        total_done += int(done.sum())
    # random policy terminates episodes well before 300 steps
    assert total_done > 8
    assert len(env.completed_returns) == total_done


def test_vector_env_steps_equal_the_reference():
    """The numpy CartPole is a copy: the same seed and actions give the
    same observations, rewards and dones, bit for bit."""
    from ray_tpu.rl import CartPoleVec as JaxCartPole
    from ray_tpu_torch.rl import CartPoleVec
    ours, ref = CartPoleVec(16, seed=4), JaxCartPole(16, seed=4)
    rng = np.random.RandomState(0)
    for _ in range(200):
        actions = rng.randint(0, 2, 16)
        for got, want in zip(ours.step(actions), ref.step(actions)):
            np.testing.assert_array_equal(got, want)
    assert ours.drain_episode_returns() == ref.drain_episode_returns()


def test_init_policy_params_shapes_match_the_reference():
    """``init_policy_params`` draws from a torch.Generator where the
    reference splits a PRNGKey: same keys, shapes and dtypes, the same
    scale, the same draws for the same generator seed."""
    import jax
    import torch
    from ray_tpu.rl import init_policy_params as jax_init
    from ray_tpu_torch.rl import init_policy_params
    ref = jax_init(jax.random.PRNGKey(0), 4, 2, 64)
    ours = init_policy_params(torch.Generator().manual_seed(0), 4, 2, 64)
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].shape == ref[k].shape and ours[k].dtype == np.float32
    assert abs(ours["w2"].std() * 8 - 1) < 0.1     # N(0, 1) / sqrt(64)
    again = init_policy_params(torch.Generator().manual_seed(0), 4, 2, 64)
    for k in ours:
        np.testing.assert_array_equal(ours[k], again[k])


def test_env_runner_group_collects(ray_start_regular):
    import torch
    from ray_tpu_torch.rl import EnvRunnerGroup, init_policy_params
    params = init_policy_params(torch.Generator().manual_seed(0), 4, 2)
    group = EnvRunnerGroup("CartPole", num_runners=2,
                           num_envs_per_runner=4, seed=0)
    try:
        rollouts = group.collect(params, rollout_len=16)
        assert len(rollouts) == 2
        for r in rollouts:
            assert r["obs"].shape == (16, 4, 4)
            assert r["actions"].shape == (16, 4)
            assert r["logp"].shape == (16, 4)
            assert r["last_obs"].shape == (4, 4)
            assert set(np.unique(r["actions"])) <= {0, 1}
        # a runner's rollout equals the reference's runner on the same
        # params and seed (the numpy forward and sampling are copies)
        from ray_tpu.rl.env_runner import EnvRunner as JaxRunner
        ref = JaxRunner("CartPole", 4, seed=0).collect(params, 16)
        for key in ("obs", "actions", "logp", "rewards", "dones",
                    "last_obs", "episode_returns"):
            np.testing.assert_array_equal(rollouts[0][key], ref[key])
    finally:
        group.shutdown()


def test_replay_buffer_wraps_and_samples():
    from ray_tpu_torch.rl import ReplayBuffer
    buf = ReplayBuffer(capacity=100, obs_dim=4)
    batch = {
        "obs": np.random.randn(30, 2, 4).astype(np.float32),
        "actions": np.zeros((30, 2), np.int32),
        "rewards": np.ones((30, 2), np.float32),
        "dones": np.zeros((30, 2), bool),
        "last_obs": np.zeros((2, 4), np.float32),
        "episode_returns": np.zeros(0, np.float32),
    }
    buf.add_rollout(batch)
    assert len(buf) == 60
    buf.add_rollout(batch)   # wraps past capacity
    assert len(buf) == 100
    rng = np.random.RandomState(0)
    sample = buf.sample(rng, 32)
    assert sample["obs"].shape == (32, 4)
    assert sample["rewards"].shape == (32,)
    many = buf.sample_many(rng, 3, 8)
    assert many["obs"].shape == (3, 8, 4) and many["actions"].shape == (3, 8)
    state = buf.state_dict()
    other = ReplayBuffer(capacity=100, obs_dim=4)
    other.load_state_dict(state)
    assert len(other) == 100
    np.testing.assert_array_equal(other.sample(np.random.RandomState(1), 8)
                                  ["obs"],
                                  buf.sample(np.random.RandomState(1), 8)
                                  ["obs"])


def test_ppo_resource_gang(ray_start_regular):
    """The PG reserves the heterogeneous learner+runner bundles: the
    learner's bundle asks for GPU where the reference asks for TPU."""
    from ray_tpu_torch.rl import PPOConfig
    from ray_tpu_torch.util.placement_group import placement_group_table
    algo = (PPOConfig()
            .environment("CartPole")
            .env_runners(num_env_runners=2, num_envs_per_runner=4,
                         rollout_length=8)
            .training(device="cpu")
            .build())
    try:
        assert algo._pg is not None
        entries = [e for e in placement_group_table()
                   if e.get("state") == "CREATED"]
        assert entries, "ppo placement group not created"
        assert algo._default_learner_bundle() == {"GPU": 8.0, "CPU": 1.0}
        result = algo.train()
        assert result["num_env_steps_sampled"] == 8 * 2 * 4
        assert np.isfinite(result["loss"])
    finally:
        algo.stop()


def test_learner_devices_above_one_refused(ray_start_regular):
    """``learner_devices`` above the host's card count is refused with
    ``ValueError`` (the reference's ``make_mesh`` refuses more devices
    than it has); above one on the CPU, the learner is a gang of that
    many gloo ranks, which ``stop()`` closes."""
    import torch
    from ray_tpu_torch.rl import IMPALAConfig, PPOConfig
    from ray_tpu_torch.rl.ppo import DPUpdate
    for config in (PPOConfig(), IMPALAConfig()):
        # twice the cards, or 2 without one: the divisor loop over the
        # default 32 envs keeps it, so it stays above the card count
        config.learner_devices = 2 * max(torch.cuda.device_count(), 1)
        with pytest.raises(ValueError, match="the host has"):
            config.build()
    algo = (PPOConfig()
            .environment("CartPole")
            .env_runners(num_env_runners=2, num_envs_per_runner=2,
                         rollout_length=8)
            .training(device="cpu")
            .resources(learner_devices=2)
            .build())
    try:
        assert algo.learners == 2
        assert isinstance(algo._update, DPUpdate)
        assert algo._update.ranks.world_size == 2
        result = algo.train()
        assert np.isfinite(result["loss"])
    finally:
        algo.stop()
    assert not any(p.is_alive() for p in algo._gang.ranks._procs)


def test_learners_default_to_the_card(ray_start_regular):
    """Every algorithm's learner runs on ``"cuda"`` unless its config asks
    for the CPU; without a card, building one raises before it starts any
    runner."""
    import torch
    from ray_tpu_torch.rl import (DQNConfig, IMPALAConfig,
                                  MultiAgentPPOConfig, PPOConfig)
    configs = (PPOConfig(), DQNConfig(), IMPALAConfig(),
               MultiAgentPPOConfig())
    assert all(c.device == "cuda" for c in configs)
    if torch.cuda.is_available():
        return
    from ray_tpu_torch.util.placement_group import placement_group_table
    for config in configs:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            config.build()
    assert not placement_group_table()
