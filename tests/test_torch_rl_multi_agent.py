"""Multi-agent PPO on the port: the cases of the JAX package's
``tests/test_rl.py`` on policy mapping. TwoTargets gives both agents
IDENTICAL observations but DIFFERENT optimal actions, so one shared policy
cannot win: reaching the threshold (``>= 6.0`` per agent within 40
iterations, the reference's seed 3) proves per-policy learning through the
mapping. The learner runs on the CPU (``device="cpu"``), starting from the
JAX package's stacked initial parameters for the seed, carried across as
numpy through ``restore``."""

import numpy as np
import pytest

import ray_tpu_torch as rt
from tests.test_torch_rl_learning import restore_from


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


def test_two_targets_env_equals_the_reference():
    """The multi-agent env is a copy: the same seed and actions give the
    same observations, rewards and dones."""
    from ray_tpu.rl import TwoTargetsEnv as JaxTwoTargets
    from ray_tpu_torch.rl import TwoTargetsEnv
    ours, ref = TwoTargetsEnv(8, seed=2), JaxTwoTargets(8, seed=2)
    rng = np.random.RandomState(0)
    for _ in range(20):
        actions = {a: rng.randint(0, 4, 8) for a in ref.agent_ids}
        (o1, r1, d1), (o2, r2, d2) = ours.step(actions), ref.step(actions)
        np.testing.assert_array_equal(d1, d2)
        for a in ref.agent_ids:
            np.testing.assert_array_equal(o1[a], o2[a])
            np.testing.assert_array_equal(r1[a], r2[a])


def test_multi_agent_ppo_learns_distinct_policies(ray_start_regular):
    import jax
    from ray_tpu.rl import ppo as jppo
    from ray_tpu_torch.rl import MultiAgentPPOConfig
    algo = MultiAgentPPOConfig(
        num_env_runners=2, num_envs_per_runner=16,
        rollout_length=32, seed=3, device="cpu").build()
    try:
        cfg = algo.config
        per_policy = [jax.tree.map(np.asarray, jppo.init_policy_params(
            k, algo.obs_dim, algo.num_actions, cfg.hidden))
            for k in jax.random.split(jax.random.PRNGKey(cfg.seed),
                                      len(algo.policies))]
        params = {k: np.stack([p[k] for p in per_policy])
                  for k in per_policy[0]}
        restore_from(algo, {
            "params": params,
            "m": {k: np.zeros_like(x) for k, x in params.items()},
            "v": {k: np.zeros_like(x) for k, x in params.items()},
            "iteration": 0, "step_count": 0, "policies": algo.policies})
        best = {}
        for _ in range(40):
            result = algo.train()
            best = {p: max(best.get(p, 0.0), v)
                    for p, v in result["policy_return_means"].items()}
            # per-episode max return = EP_LEN = 8; random ~ 2
            if all(v >= 6.0 for v in best.values()):
                break
        assert set(best) == {"alice", "bob"}
        assert all(v >= 6.0 for v in best.values()), best
        # checkpoint round trip keeps the stacked state
        import os
        import tempfile
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "ck.pkl")
            algo.save(path)
            it = algo.iteration
            algo.restore(path)
            assert algo.iteration == it
    finally:
        algo.stop()


def test_multi_agent_shared_policy_mapping(ray_start_regular):
    """Mapping both agents onto ONE policy must run (and hit the
    shared-policy ceiling — it cannot satisfy both targets)."""
    from ray_tpu_torch.rl import MultiAgentPPOConfig
    algo = MultiAgentPPOConfig(
        num_env_runners=1, num_envs_per_runner=8, rollout_length=16,
        policies=["shared"],
        policy_mapping_fn=lambda agent_id: "shared", seed=0,
        device="cpu").build()
    try:
        result = None
        for _ in range(3):
            result = algo.train()
        assert list(result["policy_return_means"]) == ["shared"]
        assert algo.params["w1"].shape[0] == 1
    finally:
        algo.stop()


def test_unmapped_policy_refused(ray_start_regular):
    from ray_tpu_torch.rl import MultiAgentPPOConfig
    with pytest.raises(ValueError, match="outside the policy table"):
        MultiAgentPPOConfig(policies=["alice"], device="cpu").build()
