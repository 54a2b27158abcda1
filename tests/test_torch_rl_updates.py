"""One learner update of the port's PPO, DQN and multi-agent PPO against
the JAX package's on the same numpy parameters, optimizer state and batch,
to the reference's V-trace bound (1e-4, ``tests/test_impala.py``).

The JAX side is the algorithm's own jitted update, built as the algorithm
builds it (``_build_update`` / ``_make_update`` over a ``dp`` mesh of every
local CPU device, its inputs put with the shardings its ``train`` uses),
on an instance made without its runners, which the update never reads. The
port's side is its update on the CPU (``device="cpu"``), dp = 1, so the
sums run in another order.
"""

import numpy as np
import pytest

TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    import torch
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def jax_learner(cls, config, batch_envs):
    """An instance of the JAX package's algorithm ``cls`` holding only what
    its update needs: ``config``, and the mesh its ``__init__`` builds (dp
    the largest device count that divides ``batch_envs``)."""
    import jax
    from ray_tpu.parallel.mesh import MeshSpec, make_mesh
    algo = cls.__new__(cls)
    algo.config = config
    n_dev = len(jax.devices())
    while n_dev > 1 and batch_envs % n_dev != 0:
        n_dev -= 1
    algo.mesh = make_mesh(MeshSpec(dp=n_dev))
    return algo


def put_sharded(algo, params, m, v, obs, batch, last_obs, t, stacked=False):
    """The update's arguments put as the algorithm's ``train`` puts them."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    if stacked:
        obs_sh, batch_sh, last_sh, rep = algo._shardings
    else:
        obs_sh, batch_sh, rep = algo._shardings
        last_sh = NamedSharding(algo.mesh, P("dp"))
    return ([jax.device_put(x, rep) for x in (params, m, v)]
            + [jax.device_put(obs, obs_sh)]
            + [jax.device_put(x, batch_sh) for x in batch]
            + [jax.device_put(last_obs, last_sh), jnp.int32(t)])


def rollout_batch(rng, T, B, obs_dim, num_actions, lead=()):
    """A seeded rollout: obs, actions, behaviour log-probs, rewards, dones
    (about 1 in 10 done) and the last observation."""
    obs = rng.randn(*lead, T, B, obs_dim).astype(np.float32)
    actions = rng.randint(0, num_actions, (*lead, T, B)).astype(np.int32)
    logp = np.log(rng.uniform(0.2, 0.8, (*lead, T, B))).astype(np.float32)
    rewards = rng.uniform(0.0, 1.0, (*lead, T, B)).astype(np.float32)
    dones = rng.uniform(size=(*lead, T, B)) < 0.1
    last_obs = rng.randn(*lead, B, obs_dim).astype(np.float32)
    return obs, actions, logp, rewards, dones, last_obs


def moments(rng, params, t0):
    """Zero Adam moments at step 0; seeded ones (v > 0) later."""
    if t0 == 0:
        return ({k: np.zeros_like(x) for k, x in params.items()},
                {k: np.zeros_like(x) for k, x in params.items()})
    return ({k: (0.01 * rng.randn(*x.shape)).astype(np.float32)
             for k, x in params.items()},
            {k: (1e-4 * rng.uniform(0.1, 1.0, x.shape)).astype(np.float32)
             for k, x in params.items()})


def assert_trees_close(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=TOL, atol=TOL,
                                   err_msg=f"{what}[{k}]")


@pytest.mark.parametrize("t0", [0, 16])
def test_ppo_update_matches_jax(t0):
    import jax
    from ray_tpu.rl import ppo as jppo
    from ray_tpu_torch.rl import ppo
    rng = np.random.RandomState(t0)
    T, B = 16, 16
    kw = dict(epochs=4, hidden=32, lr=3e-3)
    params = jax.tree.map(np.asarray, jppo.init_policy_params(
        jax.random.PRNGKey(1), 4, 2, kw["hidden"]))
    m, v = moments(rng, params, t0)
    obs, *batch, last_obs = rollout_batch(rng, T, B, 4, 2)

    algo = jax_learner(jppo.PPO, jppo.PPOConfig(**kw), B)
    algo._update = algo._build_update()
    want = algo._update(*put_sharded(algo, params, m, v, obs, batch,
                                     last_obs, t0))
    got = ppo.make_update(ppo.PPOConfig(**kw), "cpu")(
        params, m, v, obs, *batch, last_obs, t0)
    for name, g, w in zip(("params", "m", "v"), got[:3], want[:3]):
        assert_trees_close(g, jax.tree.map(np.asarray, w), name)
    np.testing.assert_allclose(got[3], np.asarray(want[3]), rtol=TOL,
                               atol=TOL)


def test_dqn_update_matches_jax():
    """K = 4 Adam steps of the double-DQN loss, from an optax state three
    steps in (carried across by ``adam_state_from_optax``)."""
    import jax
    import optax
    from ray_tpu.rl import dqn as jdqn
    from ray_tpu_torch.models.convert import adam_state_from_optax
    from ray_tpu_torch.rl import dqn
    rng = np.random.RandomState(3)
    K, N, hidden = 4, 32, 32
    cfg = jdqn.DQNConfig(lr=1e-3, gamma=0.99, hidden=hidden)
    params = jax.tree.map(np.asarray, jdqn.init_q_params(
        jax.random.PRNGKey(0), 4, 2, hidden))
    target = {k: (x + 0.05 * rng.randn(*x.shape)).astype(np.float32)
              for k, x in params.items()}
    tx = optax.adam(cfg.lr)
    state = tx.init(params)
    for _ in range(3):        # a state with count 3 and nonzero moments
        grads = {k: (0.1 * rng.randn(*x.shape)).astype(np.float32)
                 for k, x in params.items()}
        _, state = tx.update(grads, state, params)
    state = jax.tree.map(np.asarray, state)
    batches = {"obs": rng.randn(K, N, 4).astype(np.float32),
               "next_obs": rng.randn(K, N, 4).astype(np.float32),
               "actions": rng.randint(0, 2, (K, N)).astype(np.int32),
               "rewards": np.ones((K, N), np.float32),
               "dones": (rng.uniform(size=(K, N)) < 0.1).astype(np.float32)}

    algo = jdqn.DQN.__new__(jdqn.DQN)
    algo.cfg, algo._tx = cfg, tx
    w_params, w_state, w_losses = jax.jit(algo._make_update())(
        params, state, target, batches)
    g_params, g_state, g_losses = dqn.make_update(
        dqn.DQNConfig(lr=1e-3, gamma=0.99, hidden=hidden), "cpu")(
            params, adam_state_from_optax(state), target, batches)
    assert_trees_close(g_params, jax.tree.map(np.asarray, w_params),
                       "params")
    want_state = adam_state_from_optax(jax.tree.map(np.asarray, w_state))
    assert int(g_state["count"]) == int(want_state["count"]) == 3 + K
    assert_trees_close(g_state["m"], want_state["m"], "m")
    assert_trees_close(g_state["v"], want_state["v"], "v")
    np.testing.assert_allclose(g_losses, np.asarray(w_losses), rtol=TOL,
                               atol=TOL)


def test_multi_agent_update_matches_jax():
    """Two stacked policies: the port's ``torch.func.vmap`` of the
    single-policy update against the reference's ``jax.vmap`` in one jit."""
    import jax
    from ray_tpu.rl import multi_agent as jma
    from ray_tpu.rl import ppo as jppo
    from ray_tpu_torch.rl import multi_agent as ma
    rng = np.random.RandomState(5)
    T, B, P = 8, 16, 2
    kw = dict(epochs=3, hidden=16)
    keys = jax.random.split(jax.random.PRNGKey(3), P)
    per_policy = [jax.tree.map(np.asarray,
                               jppo.init_policy_params(k, 4, 4, kw["hidden"]))
                  for k in keys]
    params = {k: np.stack([p[k] for p in per_policy]) for k in per_policy[0]}
    m, v = moments(rng, params, 6)
    obs, *batch, last_obs = rollout_batch(rng, T, B, 4, 4, lead=(P,))

    algo = jax_learner(jma.MultiAgentPPO, jma.MultiAgentPPOConfig(**kw), B)
    algo._update = algo._build_update()
    want = algo._update(*put_sharded(algo, params, m, v, obs, batch,
                                     last_obs, 6, stacked=True))
    got = ma.make_update(ma.MultiAgentPPOConfig(**kw), "cpu")(
        params, m, v, obs, *batch, last_obs, 6)
    for name, g, w in zip(("params", "m", "v"), got, want):
        assert_trees_close(g, jax.tree.map(np.asarray, w), name)


def test_multi_agent_update_is_the_single_policy_update():
    """The vmapped update of P stacked policies equals P single-policy
    updates, policy by policy."""
    from ray_tpu_torch.rl import multi_agent as ma
    from ray_tpu_torch.rl import ppo
    import torch
    rng = np.random.RandomState(7)
    T, B, P = 8, 8, 3
    cfg = ma.MultiAgentPPOConfig(epochs=2, hidden=16)
    gen = torch.Generator().manual_seed(0)
    per_policy = [ppo.init_policy_params(gen, 4, 4, cfg.hidden)
                  for _ in range(P)]
    params = {k: np.stack([p[k] for p in per_policy]) for k in per_policy[0]}
    m, v = moments(rng, params, 4)
    obs, *batch, last_obs = rollout_batch(rng, T, B, 4, 4, lead=(P,))
    stacked = ma.make_update(cfg, "cpu")(params, m, v, obs, *batch,
                                         last_obs, 4)
    single = ppo.make_update(
        ppo.PPOConfig(lr=cfg.lr, gamma=cfg.gamma, lam=cfg.lam, clip=cfg.clip,
                      epochs=cfg.epochs, vf_coeff=cfg.vf_coeff,
                      entropy_coeff=cfg.entropy_coeff), "cpu")
    def pick(i, tree):
        return {k: x[i] for k, x in tree.items()}

    for i in range(P):
        one = single(pick(i, params), pick(i, m), pick(i, v), obs[i],
                     *(x[i] for x in batch), last_obs[i], 4)
        for name, g, w in zip(("params", "m", "v"), one[:3], stacked):
            assert_trees_close(g, pick(i, w), f"policy {i} {name}")
