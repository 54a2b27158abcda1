"""ray_tpu_torch.rl — reinforcement learning on the core API (the
counterpart of ``ray_tpu/rl``).

Reference: ``rllib/`` [UNVERIFIED — mount empty, SURVEY.md §0]. The
shape is RLlib's: an AlgorithmConfig builder, an algorithm driving an
EnvRunnerGroup (CPU rollout actors) and a learner, vectorized envs, a
placement-group resource gang. The learner runs in the driver, on the
card by default (``device="cuda"``; a config's ``device="cpu"`` runs it
on the CPU), as plain torch instead of a DDP actor gang (see
``ppo.py``). Runners are CPU process workers that load no torch.
"""

from ray_tpu_torch.rl.env import (
    CartPoleVec, VectorEnv, make_env, register_env)
from ray_tpu_torch.rl.env_runner import EnvRunner, EnvRunnerGroup
from ray_tpu_torch.rl.dqn import DQN, DQNConfig, ReplayBuffer, init_q_params
from ray_tpu_torch.rl.impala import (
    IMPALA, IMPALAConfig, AsyncEnvRunner, vtrace_targets)
from ray_tpu_torch.rl.ppo import PPO, PPOConfig, init_policy_params
from ray_tpu_torch.rl.multi_agent import (
    MultiAgentEnvRunner,
    MultiAgentPPO,
    MultiAgentPPOConfig,
    MultiAgentVectorEnv,
    TwoTargetsEnv,
    make_multi_agent_env,
    register_multi_agent_env,
)

__all__ = [
    "PPO", "PPOConfig", "DQN", "DQNConfig", "ReplayBuffer",
    "IMPALA", "IMPALAConfig", "AsyncEnvRunner", "vtrace_targets",
    "EnvRunner", "EnvRunnerGroup", "VectorEnv",
    "CartPoleVec", "make_env", "register_env", "init_policy_params",
    "init_q_params",
    "MultiAgentPPO", "MultiAgentPPOConfig", "MultiAgentVectorEnv",
    "MultiAgentEnvRunner", "TwoTargetsEnv", "make_multi_agent_env",
    "register_multi_agent_env",
]
