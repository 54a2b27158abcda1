"""The port's RL learner over a gang of ranks (``make_dp_update``: 4 gloo
ranks on the CPU) against the JAX package's learner on
``make_mesh(MeshSpec(dp=4))`` and against the port's one-device update.

The JAX side is the algorithm's own jitted update, built as
``test_torch_rl_updates.py::jax_learner`` builds it but on a dp = 4 mesh
of 4 of the 8 CPU devices, its inputs put with the shardings its ``train``
uses. Same numpy params, Adam moments and batch; the reference's bound,
1e-4. One gang of 4 ranks serves the whole file. The test file imports
JAX only inside functions, so that a spawned rank does not import it.
"""

import os

import numpy as np
import pytest
import torch

from ray_tpu_torch.parallel.launch import LocalRanks

WORLD = 4
TOL = 1e-4

# (algorithm, Adam step the update starts from)
CASES = [("ppo", 0), ("ppo", 16), ("impala", 1), ("impala", 17),
         ("multi_agent", 0), ("multi_agent", 6)]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def ranks():
    with LocalRanks(WORLD, device="cpu") as r:
        yield r


def _moments(rng, params, t0):
    """Zero Adam moments at step 0; seeded ones (v > 0) later."""
    if t0 == 0:
        return ({k: np.zeros_like(x) for k, x in params.items()},
                {k: np.zeros_like(x) for k, x in params.items()})
    return ({k: (0.01 * rng.randn(*x.shape)).astype(np.float32)
             for k, x in params.items()},
            {k: (1e-4 * rng.uniform(0.1, 1.0, x.shape)).astype(np.float32)
             for k, x in params.items()})


def _batch(rng, T, B, num_actions, lead=(), spread=False):
    """A seeded rollout: obs, actions, behaviour log-probs, rewards, dones
    (about 1 in 10 done) and the last observation. ``spread``: block r of
    B (rank r's columns) gets rewards around 10 r, scaled by 4 ** r, so
    that each rank's advantages have their own mean and spread."""
    obs = rng.randn(*lead, T, B, 4).astype(np.float32)
    actions = rng.randint(0, num_actions, (*lead, T, B)).astype(np.int32)
    logp = np.log(rng.uniform(0.2, 0.8, (*lead, T, B))).astype(np.float32)
    rewards = rng.uniform(0.0, 1.0, (*lead, T, B)).astype(np.float32)
    if spread:
        col = np.arange(B) // (B // WORLD)
        rewards = (rewards * 4.0 ** col + 10.0 * col).astype(np.float32)
    dones = rng.uniform(size=(*lead, T, B)) < 0.1
    last_obs = rng.randn(*lead, B, 4).astype(np.float32)
    return obs, [actions, logp, rewards, dones], last_obs


def _setup(name, t0, spread=False):
    """(port module, port config, JAX module, JAX config, params, m, v,
    obs, batch, last_obs, stacked) for one case, from numpy seeds."""
    import jax
    from ray_tpu.rl import impala as jimpala
    from ray_tpu.rl import multi_agent as jma
    from ray_tpu.rl import ppo as jppo
    from ray_tpu_torch.rl import impala, multi_agent, ppo
    rng = np.random.RandomState(100 + t0)
    hidden = 16
    if name == "multi_agent":
        keys = jax.random.split(jax.random.PRNGKey(3), 2)
        per_policy = [jax.tree.map(np.asarray, jppo.init_policy_params(
            k, 4, 4, hidden)) for k in keys]
        params = {k: np.stack([p[k] for p in per_policy])
                  for k in per_policy[0]}
        obs, batch, last_obs = _batch(rng, 8, 16, 4, lead=(2,),
                                      spread=spread)
        kw = dict(epochs=3, hidden=hidden)
        port, jmod = multi_agent, jma
        cfg, jcfg = (multi_agent.MultiAgentPPOConfig(**kw),
                     jma.MultiAgentPPOConfig(**kw))
    else:
        params = jax.tree.map(np.asarray, jppo.init_policy_params(
            jax.random.PRNGKey(1), 4, 2, hidden))
        obs, batch, last_obs = _batch(rng, 16, 16, 2, spread=spread)
        if name == "ppo":
            kw = dict(epochs=4, hidden=hidden, lr=3e-3)
            port, jmod = ppo, jppo
            cfg, jcfg = ppo.PPOConfig(**kw), jppo.PPOConfig(**kw)
        else:
            kw = dict(hidden=hidden, lr=3e-3)
            port, jmod = impala, jimpala
            cfg, jcfg = impala.IMPALAConfig(**kw), jimpala.IMPALAConfig(**kw)
    m, v = _moments(rng, params, t0)
    return (port, cfg, jmod, jcfg, params, m, v, obs, batch, last_obs,
            name == "multi_agent")


_jax_updates = {}


def _jax_dp_update(jmod, jcfg, params, m, v, obs, batch, last_obs, t0,
                   stacked):
    """The JAX package's update on dp = 4, as its ``train`` calls it."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ray_tpu.parallel.mesh import MeshSpec, make_mesh
    name = jmod.__name__.rsplit(".", 1)[1]
    if name not in _jax_updates:     # one jit per algorithm: same config
        cls = getattr(jmod, {"multi_agent": "MultiAgentPPO", "ppo": "PPO",
                             "impala": "IMPALA"}[name])
        algo = cls.__new__(cls)
        algo.config = jcfg
        algo.mesh = make_mesh(MeshSpec(dp=WORLD))
        _jax_updates[name] = (algo, algo._build_update())
    algo, update = _jax_updates[name]
    if stacked:
        obs_sh, batch_sh, last_sh, rep = algo._shardings
    else:
        obs_sh, batch_sh, rep = algo._shardings
        last_sh = NamedSharding(algo.mesh, P("dp"))
    out = update(*[jax.device_put(x, rep) for x in (params, m, v)],
                 jax.device_put(obs, obs_sh),
                 *[jax.device_put(x, batch_sh) for x in batch],
                 jax.device_put(last_obs, last_sh), jnp.int32(t0))
    return jax.tree.map(np.asarray, out)


def _close(got, want, what):
    """The first three entries (params, m, v) and, where both have it, the
    loss, every element within TOL."""
    for name, g, w in zip(("params", "m", "v"), got[:3], want[:3]):
        assert set(g) == set(w), what
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=TOL,
                                       err_msg=f"{what} {name}[{k}]")
    if len(got) > 3 and len(want) > 3:
        np.testing.assert_allclose(got[3], want[3], rtol=TOL, atol=TOL,
                                   err_msg=f"{what} loss")


def _gang_update(ranks, port, cfg, params, m, v, obs, batch, last_obs, t0):
    update = port.make_dp_update(cfg, WORLD, "cpu", ranks=ranks)
    return update(params, m, v, obs, *batch, last_obs, t0)


@pytest.mark.parametrize("name,t0", CASES)
def test_gang_update_matches_jax_dp4(ranks, name, t0):
    (port, cfg, jmod, jcfg, params, m, v, obs, batch, last_obs,
     stacked) = _setup(name, t0)
    got = _gang_update(ranks, port, cfg, params, m, v, obs, batch,
                       last_obs, t0)
    want = _jax_dp_update(jmod, jcfg, params, m, v, obs, batch, last_obs,
                          t0, stacked)
    _close(got, want, f"{name} t0={t0} vs JAX dp={WORLD}")


@pytest.mark.parametrize("name,t0", CASES)
def test_gang_update_matches_one_device(ranks, name, t0):
    (port, cfg, _, _, params, m, v, obs, batch, last_obs,
     _) = _setup(name, t0)
    got = _gang_update(ranks, port, cfg, params, m, v, obs, batch,
                       last_obs, t0)
    want = port.make_update(cfg, "cpu")(params, m, v, obs, *batch,
                                        last_obs, t0)
    _close(got, want, f"{name} t0={t0} vs one device")


def shard_local_ppo_update(*args, **hyper):
    """``ppo_update_dp`` with each rank normalising its advantages by its
    own moments (what the global normalisation must not be): run on the
    ranks by ``test_normalisation_is_global``."""
    from ray_tpu_torch.rl import ppo

    def local(adv, count):
        mean = adv.mean((-2, -1), keepdim=True)
        return mean, adv.std((-2, -1), correction=0, keepdim=True)

    saved = ppo._psum_moments
    ppo._psum_moments = local
    try:
        return ppo.ppo_update_dp(*args, **hyper)
    finally:
        ppo._psum_moments = saved


@pytest.mark.parametrize("name", ["ppo", "multi_agent"])
def test_normalisation_is_global(ranks, name):
    """Block r of B carries rewards around 10 r at 4 ** r their scale:
    the gang normalises with the moments of all T x B advantages, as JAX
    does, and a shard-local normalisation lands far outside the bound."""
    from ray_tpu_torch.rl import ppo
    (port, cfg, jmod, jcfg, params, m, v, obs, batch, last_obs,
     stacked) = _setup(name, 6, spread=True)
    got = _gang_update(ranks, port, cfg, params, m, v, obs, batch,
                       last_obs, 6)
    want = _jax_dp_update(jmod, jcfg, params, m, v, obs, batch, last_obs,
                          6, stacked)
    _close(got, want, f"{name} spread vs JAX dp={WORLD}")
    local = ppo.DPUpdate(shard_local_ppo_update,
                         {**ppo.ppo_hyper(cfg), "stacked": stacked}, WORLD,
                         "cpu", lead=int(stacked), outputs=3, ranks=ranks)(
        params, m, v, obs, *batch, last_obs, 6)
    gap = max(float(np.max(np.abs(a[k] - b[k])))
              for a, b in zip(local[:2], want[:2]) for k in b)
    assert gap > 10 * TOL, gap


@pytest.mark.parametrize("requested,envs", [
    (None, 32), (None, 12), (None, 6), (None, 5), (4, 32), (3, 32),
    (8, 30), (6, 9), (1, 32), (5, 25)])
def test_learner_count_is_the_reference_divisor_loop(monkeypatch,
                                                     requested, envs):
    """``learner_count`` lowers the count as the reference's ``__init__``
    does (``ppo.py:166-169``), with 8 cards against JAX's 8 CPU devices;
    on the CPU an unset count is 1."""
    import jax
    from ray_tpu_torch.rl.ppo import learner_count
    n_dev = requested or len(jax.devices())
    while n_dev > 1 and envs % n_dev != 0:
        n_dev -= 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert len(jax.devices()) == 8
    assert learner_count("cuda", requested, envs) == n_dev
    if requested is None:
        assert learner_count("cpu", None, envs) == 1
    elif n_dev <= (os.cpu_count() or 1):
        assert learner_count("cpu", requested, envs) == n_dev


def test_learner_count_above_the_devices_raises(monkeypatch):
    """More learners than cards raise ``ValueError``, as the reference's
    ``make_mesh`` does for more devices than it has."""
    from ray_tpu.parallel.mesh import MeshSpec, make_mesh
    from ray_tpu_torch.rl.ppo import learner_count
    with pytest.raises(ValueError):
        make_mesh(MeshSpec(dp=16))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="the host has 2"):
        learner_count("cuda", 4, 32)
    assert learner_count("cuda", 2, 32) == 2


@pytest.mark.cuda
def test_gang_of_one_on_the_card_matches_the_driver():
    """On the card: PPO's update over a gang of one NCCL rank equals the
    in-driver update on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from ray_tpu_torch.rl import ppo
    rng = np.random.RandomState(0)
    cfg = ppo.PPOConfig(epochs=4, hidden=16)
    params = ppo.init_policy_params(torch.Generator().manual_seed(0), 4, 2,
                                    16)
    m, v = _moments(rng, params, 0)
    obs, batch, last_obs = _batch(rng, 16, 16, 2)
    gang = ppo.make_dp_update(cfg, 1, "cuda")
    try:
        got = gang(params, m, v, obs, *batch, last_obs, 0)
    finally:
        gang.close()
    want = ppo.make_update(cfg, "cuda")(params, m, v, obs, *batch,
                                        last_obs, 0)
    _close(got, want, "gang of one vs driver")
