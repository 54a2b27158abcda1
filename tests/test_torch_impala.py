"""IMPALA on the port: the cases of the JAX package's
``tests/test_impala.py`` (V-trace against the numpy mirror, the on-policy
reduction, the decoupled learning gate), plus ``vtrace_targets`` and one
learner update against the JAX package's on the same numpy inputs, at the
reference's bound (rtol and atol 1e-4).

The learning test keeps the reference's seed, budget and thresholds. It
starts from the JAX package's initial parameters for that seed, carried
across as numpy through ``restore``, since ``jax.random`` cannot be
reproduced in torch."""

import os
import pickle
import tempfile

import numpy as np
import pytest

import ray_tpu_torch as rt
from tests.test_torch_rl_updates import (
    TOL, assert_trees_close, jax_learner, moments, put_sharded,
    rollout_batch)


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


def _vtrace_numpy(values, last_value, rewards, not_done, rhos, gamma,
                  rho_clip=1.0, c_clip=1.0):
    """The reference test's numpy recursion."""
    T, B = values.shape
    rho_c = np.minimum(rhos, rho_clip)
    cs = np.minimum(rhos, c_clip)
    v_next = np.concatenate([values[1:], last_value[None]], axis=0)
    deltas = rho_c * (rewards + gamma * not_done * v_next - values)
    vs_minus_v = np.zeros((T + 1, B), np.float64)
    for t in reversed(range(T)):
        vs_minus_v[t] = (deltas[t]
                         + gamma * not_done[t] * cs[t] * vs_minus_v[t + 1])
    vs = values + vs_minus_v[:-1]
    vs_next = np.concatenate([vs[1:], last_value[None]], axis=0)
    pg_adv = rho_c * (rewards + gamma * not_done * vs_next - values)
    return vs, pg_adv


def _vtrace_inputs(seed, T, B):
    rng = np.random.RandomState(seed)
    values = rng.randn(T, B).astype(np.float32)
    last_value = rng.randn(B).astype(np.float32)
    rewards = rng.randn(T, B).astype(np.float32)
    not_done = (rng.uniform(size=(T, B)) > 0.2).astype(np.float32)
    rhos = np.exp(rng.randn(T, B).astype(np.float32) * 0.5)
    return values, last_value, rewards, not_done, rhos


def _port_vtrace(*arrays, **kw):
    import torch
    from ray_tpu_torch.rl import vtrace_targets
    vs, adv = vtrace_targets(*(torch.from_numpy(a) for a in arrays), **kw)
    return vs.numpy(), adv.numpy()


def test_vtrace_matches_numpy_reference():
    inputs = _vtrace_inputs(0, 7, 5)
    vs, adv = _port_vtrace(*inputs, gamma=0.97, rho_clip=1.0, c_clip=1.0)
    ref_vs, ref_adv = _vtrace_numpy(*inputs, gamma=0.97)
    np.testing.assert_allclose(vs, ref_vs, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(adv, ref_adv, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("clips", [(1.0, 1.0), (0.8, 1.2)])
def test_vtrace_matches_jax(clips):
    from ray_tpu.rl import vtrace_targets as jax_vtrace
    inputs = _vtrace_inputs(11, 32, 8)
    kw = dict(gamma=0.99, rho_clip=clips[0], c_clip=clips[1])
    vs, adv = _port_vtrace(*inputs, **kw)
    want_vs, want_adv = jax_vtrace(*inputs, **kw)
    np.testing.assert_allclose(vs, np.asarray(want_vs), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(adv, np.asarray(want_adv), rtol=TOL,
                               atol=TOL)


def test_vtrace_on_policy_reduces_to_td_lambda1():
    """With rho == 1 everywhere (on-policy), vs is the usual lambda=1
    return bootstrapped at last_value."""
    rng = np.random.RandomState(1)
    T, B = 6, 3
    values = rng.randn(T, B).astype(np.float32)
    last_value = rng.randn(B).astype(np.float32)
    rewards = rng.randn(T, B).astype(np.float32)
    not_done = np.ones((T, B), np.float32)
    rhos = np.ones((T, B), np.float32)
    gamma = 0.9
    vs, _ = _port_vtrace(values, last_value, rewards, not_done, rhos,
                         gamma=gamma)
    ret = np.zeros((T + 1, B), np.float64)
    ret[-1] = last_value
    for t in reversed(range(T)):
        ret[t] = rewards[t] + gamma * ret[t + 1]
    np.testing.assert_allclose(vs, ret[:-1], rtol=TOL, atol=TOL)


def test_impala_update_matches_jax():
    """One V-trace learner step (Adam at step 5 from seeded moments)."""
    import jax
    from ray_tpu.rl import impala as jimpala
    from ray_tpu.rl import ppo as jppo
    from ray_tpu_torch.rl import impala
    rng = np.random.RandomState(2)
    T, B, t = 16, 16, 5
    kw = dict(lr=3e-3, hidden=32, entropy_coeff=0.01)
    params = jax.tree.map(np.asarray, jppo.init_policy_params(
        jax.random.PRNGKey(3), 4, 2, kw["hidden"]))
    m, v = moments(rng, params, t)
    obs, *batch, last_obs = rollout_batch(rng, T, B, 4, 2)

    algo = jax_learner(jimpala.IMPALA, jimpala.IMPALAConfig(**kw), B)
    algo._update = algo._build_update()
    want = algo._update(*put_sharded(algo, params, m, v, obs, batch,
                                     last_obs, t))
    got = impala.make_update(impala.IMPALAConfig(**kw), "cpu")(
        params, m, v, obs, *batch, last_obs, t)
    for name, g, w in zip(("params", "m", "v"), got[:3], want[:3]):
        assert_trees_close(g, jax.tree.map(np.asarray, w), name)
    np.testing.assert_allclose(got[3], np.asarray(want[3]), rtol=TOL,
                               atol=TOL)


def test_impala_learns_cartpole_decoupled(ray_start_regular):
    """The learning gate, plus the decoupling signature: the learner
    must consume trajectories collected under stale weights
    (policy_lag >= 1) — rollouts and updates genuinely overlap."""
    import jax
    from ray_tpu.rl import ppo as jppo
    from ray_tpu_torch.rl import IMPALAConfig
    algo = (IMPALAConfig()
            .environment("CartPole")
            .env_runners(num_env_runners=2, num_envs_per_runner=16)
            .training(lr=3e-3, rollout_length=64, batch_rollouts=2,
                      entropy_coeff=0.01, seed=3, device="cpu")
            .build())
    try:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "init.pkl")
            params = jax.tree.map(np.asarray, jppo.init_policy_params(
                jax.random.PRNGKey(3), 4, 2, 64))
            zeros = {k: np.zeros_like(x) for k, x in params.items()}
            with open(path, "wb") as f:
                pickle.dump({"params": params, "opt_m": zeros,
                             "opt_v": dict(zeros), "iteration": 0,
                             "step_count": 0, "version": 0}, f)
            algo.restore(path)
        best = 0.0
        max_lag = 0
        for _ in range(60):
            result = algo.train()
            best = max(best, result["episode_return_mean"])
            max_lag = max(max_lag, result["policy_lag_max"])
            if best >= 120.0 and max_lag >= 1:
                break
        assert best >= 120.0, f"IMPALA failed to learn: best={best}"
        assert max_lag >= 1, (
            "no stale trajectory ever consumed — rollouts were not "
            "decoupled from the learner")
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "ckpt.pkl")
            algo.save(path)
            it = algo.iteration
            algo.restore(path)
            assert algo.iteration == it
    finally:
        algo.stop()
