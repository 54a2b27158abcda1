"""Shared AlgorithmConfig builder surface (reference:
``rllib/algorithm_config.py`` [UNVERIFIED — mount empty, SURVEY.md
§0]): the fluent environment()/env_runners()/training() methods each
algorithm config reuses. A copy of ``ray_tpu/rl/config.py``."""

from __future__ import annotations

from typing import Optional


class AlgorithmConfigBase:
    def environment(self, env: str):
        self.env = env
        return self

    def env_runners(self, *, num_env_runners: Optional[int] = None,
                    num_envs_per_runner: Optional[int] = None,
                    rollout_length: Optional[int] = None):
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_runner is not None:
            self.num_envs_per_runner = num_envs_per_runner
        if rollout_length is not None:
            self.rollout_length = rollout_length
        return self

    def training(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown training option {k!r}")
            setattr(self, k, v)
        return self
