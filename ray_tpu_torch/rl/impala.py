"""IMPALA: decoupled async rollouts + V-trace off-policy learner.

Counterpart of ``ray_tpu/rl/impala.py``. Reference:
``rllib/algorithms/impala/`` (and ``appo/``) [UNVERIFIED — mount empty,
SURVEY.md §0]: rollout workers collect continuously with whatever weights
they last received; the learner consumes stale trajectories as they
arrive and corrects the off-policy gap with V-trace (Espeholt et al.
2018) importance weighting; weights broadcast periodically, never
synchronously.

The port's shape, same split as PPO here:

- rollout actors are ASYNC actors in process workers: ``collect`` yields
  to the event loop every step, so a ``set_params`` broadcast lands
  MID-ROLLOUT — the behavior policy can change inside one trajectory,
  which is exactly the regime V-trace's per-step importance ratios
  handle (behavior log-p is recorded per step from whatever params
  produced the action).
- the driver never blocks a collection barrier: one collect is kept
  in flight per runner; ``wait`` harvests whichever finishes first and
  the next collect is resubmitted BEFORE the learner update runs, so
  actors are mid-episode while the learner steps.
- the learner is plain torch on the card in the driver: V-trace targets
  (a Python loop over T for the reference's reverse ``lax.scan``),
  policy gradient, value and entropy losses, and the Adam step of
  ``ppo.py``. The learner count is ``ppo.learner_count``'s over the
  batch's ``batch_rollouts x num_envs_per_runner`` envs; above one, a
  gang of ranks (``ppo.DPUpdate``) runs V-trace on each rank's columns of
  B and averages the gradient of the rank's local-mean loss over ``dp``.

Staleness is observable: every rollout carries the params version it
STARTED with; ``train()`` reports the consume-time lag
(``policy_lag_max`` >= 1 is the decoupling signature — the learner
advanced while that trajectory was being collected).
"""

from __future__ import annotations

import asyncio
import pickle
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rl.config import AlgorithmConfigBase
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.env_runner import _policy_forward
from ray_tpu_torch.rl.ppo import (
    DPUpdate, _entropy, _log_probs, _net, adam, init_policy_params,
    learner_device, pmean_tree, to_device, to_numpy)


# --------------------------------------------------------------------------
# V-trace targets (standalone: unit-testable against a numpy mirror)


def vtrace_targets(values, last_value, rewards, not_done, rhos,
                   gamma: float, rho_clip: float = 1.0,
                   c_clip: float = 1.0):
    """V-trace value targets and policy-gradient advantages, on tensors.

    All inputs time-major [T, B] (``last_value`` [B]); ``rhos`` are the
    UNclipped importance ratios pi/mu per step. Returns (vs, pg_adv):
    vs_t = V(x_t) + sum_k gamma^k (prod c) rho-clipped TD deltas, via
    the reverse recursion vs_t = v_t + delta_t + gamma c_t (vs_{t+1} -
    v_{t+1}); pg_adv_t = rho_t-clipped (r_t + gamma vs_{t+1} - v_t).
    """
    import torch
    rho_c = torch.clamp(rhos, max=rho_clip)
    cs = torch.clamp(rhos, max=c_clip)
    v_next = torch.cat([values[1:], last_value[None]], dim=0)
    deltas = rho_c * (rewards + gamma * not_done * v_next - values)
    vs_minus_v_next = torch.zeros_like(last_value)
    steps = [None] * values.shape[0]
    for t in reversed(range(values.shape[0])):
        vs_minus_v_next = (deltas[t]
                           + gamma * not_done[t] * cs[t] * vs_minus_v_next)
        steps[t] = vs_minus_v_next
    vs = values + torch.stack(steps)
    vs_next = torch.cat([vs[1:], last_value[None]], dim=0)
    pg_adv = rho_c * (rewards + gamma * not_done * vs_next - values)
    return vs, pg_adv


# --------------------------------------------------------------------------
# async rollout actor


class AsyncEnvRunner:
    """Async actor: collects continuously with its CURRENT weights;
    ``set_params`` broadcasts land between env steps, mid-rollout."""

    def __init__(self, env_name: str, num_envs: int, seed: int = 0):
        self.env = make_env(env_name, num_envs, seed)
        self.rng = np.random.RandomState(seed + 20_000)
        self.obs = self.env.observe()
        self.params: Optional[Dict[str, np.ndarray]] = None
        self.version = 0

    async def set_params(self, params: Dict[str, np.ndarray],
                         version: int) -> None:
        self.params = params
        self.version = version

    async def collect(self, rollout_len: int) -> Dict[str, np.ndarray]:
        T, B = rollout_len, self.env.num_envs
        obs_buf = np.empty((T, B, self.env.obs_dim), np.float32)
        act_buf = np.empty((T, B), np.int32)
        logp_buf = np.empty((T, B), np.float32)
        rew_buf = np.empty((T, B), np.float32)
        done_buf = np.empty((T, B), bool)
        version_start = self.version
        for t in range(T):
            # Yield to the event loop: a set_params call queued behind
            # this rollout executes HERE — the behavior policy changes
            # mid-trajectory, per-step logp stays truthful.
            await asyncio.sleep(0)
            obs_buf[t] = self.obs
            logits = _policy_forward(self.params, self.obs)
            z = logits - logits.max(axis=1, keepdims=True)
            probs = np.exp(z)
            probs /= probs.sum(axis=1, keepdims=True)
            gumbel = -np.log(-np.log(
                self.rng.uniform(1e-9, 1.0, logits.shape)))
            actions = np.argmax(logits + gumbel, axis=1).astype(np.int32)
            logp_buf[t] = np.log(
                probs[np.arange(B), actions] + 1e-9).astype(np.float32)
            act_buf[t] = actions
            self.obs, rew_buf[t], done_buf[t] = self.env.step(actions)
        return {
            "obs": obs_buf, "actions": act_buf, "logp": logp_buf,
            "rewards": rew_buf, "dones": done_buf,
            "last_obs": self.obs.copy(),
            "episode_returns": np.asarray(
                self.env.drain_episode_returns(), np.float32),
            "version_start": version_start,
            "version_end": self.version,
        }


# --------------------------------------------------------------------------
# the learner


def _impala_loss(params, obs, actions, behavior_logp, rewards, not_done,
                 last_obs, gamma, rho_clip, c_clip, vf_coeff,
                 entropy_coeff):
    import torch
    logits, values = _net(params, obs)               # [T, B]
    _, last_v = _net(params, last_obs)               # [B]
    logp_all, target_logp = _log_probs(logits, actions)
    rhos = torch.exp(target_logp - behavior_logp)
    vs, pg_adv = vtrace_targets(values.detach(), last_v.detach(), rewards,
                                not_done, rhos.detach(), gamma, rho_clip,
                                c_clip)
    pg_loss = -torch.mean(target_logp * pg_adv)
    vf_loss = torch.mean((values - vs) ** 2)
    return pg_loss + vf_coeff * vf_loss - entropy_coeff * _entropy(logp_all)


def impala_update(params, opt_m, opt_v, obs, actions, behavior_logp,
                  rewards, dones, last_obs, t: int, *, lr, gamma, rho_clip,
                  c_clip, vf_coeff, entropy_coeff):
    """The reference's jitted update on tensors: one Adam step (at step
    ``t``) of the V-trace loss. Returns (params, m, v, loss)."""
    import torch
    not_done = 1.0 - dones.float()
    grads, loss = torch.func.grad_and_value(_impala_loss)(
        params, obs, actions.long(), behavior_logp, rewards, not_done,
        last_obs, gamma, rho_clip, c_clip, vf_coeff, entropy_coeff)
    params, opt_m, opt_v = adam(params, opt_m, opt_v, grads, t, lr)
    return params, opt_m, opt_v, loss


def impala_update_dp(params, opt_m, opt_v, obs, actions, behavior_logp,
                     rewards, dones, last_obs, t: int, *, lr, gamma,
                     rho_clip, c_clip, vf_coeff, entropy_coeff):
    """``impala_update`` on one rank of a ``dp`` gang, inside an
    ``axis_env`` of its mesh: V-trace on the rank's columns of B, the
    gradient of its local-mean loss (and the loss) averaged over ``dp``,
    then the Adam step, alike on every rank."""
    import torch
    not_done = 1.0 - dones.float()
    grads, loss = torch.func.grad_and_value(_impala_loss)(
        params, obs, actions.long(), behavior_logp, rewards, not_done,
        last_obs, gamma, rho_clip, c_clip, vf_coeff, entropy_coeff)
    grads, loss = pmean_tree(grads, loss)
    params, opt_m, opt_v = adam(params, opt_m, opt_v, grads, t, lr)
    return params, opt_m, opt_v, loss


def impala_hyper(config) -> Dict:
    return dict(lr=config.lr, gamma=config.gamma, rho_clip=config.rho_clip,
                c_clip=config.c_clip, vf_coeff=config.vf_coeff,
                entropy_coeff=config.entropy_coeff)


def make_dp_update(config: "IMPALAConfig", n: int, device="cuda",
                   ranks=None) -> DPUpdate:
    """IMPALA's update over a gang of ``n`` ranks (``ranks``, or new
    ones), with ``make_update``'s signature; ``close()`` stops new
    ranks."""
    return DPUpdate(impala_update_dp, impala_hyper(config), n, device,
                    ranks=ranks)


def make_update(config: "IMPALAConfig", device="cuda", learners: int = 1):
    """The update on ``device`` as a function of numpy arrays, with the
    signature of the reference's jitted update: (params, opt_m, opt_v,
    obs, actions, behavior_logp, rewards, dones, last_obs, t) -> (params,
    opt_m, opt_v, loss). ``learners`` above 1: ``make_dp_update``."""
    if learners > 1:
        return make_dp_update(config, learners, device)
    dev = resolve_device(device)
    hyper = impala_hyper(config)

    def update(params, opt_m, opt_v, obs, actions, behavior_logp, rewards,
               dones, last_obs, t):
        args = to_device((params, opt_m, opt_v, obs, actions, behavior_logp,
                          rewards, dones, last_obs), dev)
        return to_numpy(impala_update(*args, int(t), **hyper))

    return update


# --------------------------------------------------------------------------
# config


@dataclass
class IMPALAConfig(AlgorithmConfigBase):
    env: str = "CartPole"
    num_env_runners: int = 2
    num_envs_per_runner: int = 16
    rollout_length: int = 64
    batch_rollouts: int = 2        # rollouts consumed per learner step
    broadcast_interval: int = 1    # learner steps between weight pushes
    lr: float = 1e-3
    gamma: float = 0.99
    rho_clip: float = 1.0
    c_clip: float = 1.0
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    hidden: int = 64
    seed: int = 0
    learner_devices: Optional[int] = None   # None: every local card
    device: str = "cuda"                    # the learner's device

    def build(self) -> "IMPALA":
        return IMPALA(self)


# --------------------------------------------------------------------------
# the algorithm


class IMPALA:
    """Tune-compatible iterative trainer: ``train()`` = harvest
    ``batch_rollouts`` finished rollouts (resubmitting each runner's
    next collect first) + one V-trace update + periodic broadcast."""

    def __init__(self, config: IMPALAConfig):
        import torch
        self.config = config
        self.device, self.learners = learner_device(
            config.device, config.learner_devices,
            config.batch_rollouts * config.num_envs_per_runner)
        rt.init()
        probe = make_env(config.env, 1, 0)
        self.obs_dim = probe.obs_dim
        self.num_actions = probe.num_actions

        self.params = init_policy_params(
            torch.Generator().manual_seed(config.seed), self.obs_dim,
            self.num_actions, config.hidden)
        self.opt_m = {k: np.zeros_like(v) for k, v in self.params.items()}
        self.opt_v = {k: np.zeros_like(v) for k, v in self.params.items()}
        self.iteration = 0
        self._step_count = 0
        self._version = 0
        self._update = make_update(config, self.device, self.learners)
        # the learner gang, when there is one: stop() closes it
        self._gang = self._update if self.learners > 1 else None

        actor_cls = rt.remote(AsyncEnvRunner)
        self._runners = [
            actor_cls.options(num_cpus=1).remote(
                config.env, config.num_envs_per_runner,
                config.seed + i * 1000)
            for i in range(config.num_env_runners)]
        rt.get([r.set_params.remote(self.params, 0)
                for r in self._runners], timeout=120)
        # one collect in flight per runner, permanently
        self._inflight: Dict[object, object] = {
            r: r.collect.remote(config.rollout_length)
            for r in self._runners}
        self._recent_returns: List[float] = []

    # -- Trainable API -------------------------------------------------

    def train(self) -> Dict:
        cfg = self.config
        t_start = time.perf_counter()
        harvested: List[Dict[str, np.ndarray]] = []
        while len(harvested) < cfg.batch_rollouts:
            refs = list(self._inflight.values())
            done, _ = rt.wait(refs, num_returns=1, timeout=300)
            if not done:
                raise TimeoutError(
                    "no rollout finished within 300s — runner actors "
                    "stalled or dead")
            ref = done[0]
            runner = next(r for r, v in self._inflight.items()
                          if v is ref)
            harvested.append(rt.get(ref, timeout=300))
            # Resubmit BEFORE the update: the runner is already
            # collecting its next trajectory while the learner steps.
            self._inflight[runner] = runner.collect.remote(
                cfg.rollout_length)

        lags = [self._version - r["version_start"] for r in harvested]
        for r in harvested:
            self._recent_returns.extend(r["episode_returns"].tolist())
        self._recent_returns = self._recent_returns[-100:]

        obs = np.concatenate([r["obs"] for r in harvested], axis=1)
        actions = np.concatenate([r["actions"] for r in harvested], axis=1)
        logp = np.concatenate([r["logp"] for r in harvested], axis=1)
        rewards = np.concatenate([r["rewards"] for r in harvested], axis=1)
        dones = np.concatenate([r["dones"] for r in harvested], axis=1)
        last_obs = np.concatenate([r["last_obs"] for r in harvested],
                                  axis=0)

        self._step_count += 1
        self.params, self.opt_m, self.opt_v, loss = self._update(
            self.params, self.opt_m, self.opt_v, obs, actions, logp,
            rewards, dones, last_obs, self._step_count)
        self._version += 1
        self.iteration += 1

        if self._version % cfg.broadcast_interval == 0:
            # fire-and-forget: runners pick the new weights up at their
            # next step boundary, wherever they are in a trajectory
            for r in self._runners:
                _ = r.set_params.remote(self.params, self._version)

        mean_ret = (float(np.mean(self._recent_returns))
                    if self._recent_returns else 0.0)
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": mean_ret,
            "loss": float(loss),
            "policy_lag_mean": float(np.mean(lags)),
            "policy_lag_max": int(max(lags)),
            "num_env_steps_sampled": (self.iteration * cfg.batch_rollouts
                                      * cfg.rollout_length
                                      * cfg.num_envs_per_runner),
            "time_this_iter_s": time.perf_counter() - t_start,
        }

    # -- checkpointing -------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump({"params": self.params, "opt_m": self.opt_m,
                         "opt_v": self.opt_v,
                         "iteration": self.iteration,
                         "step_count": self._step_count,
                         "version": self._version}, f)

    def restore(self, path: str) -> None:
        with open(path, "rb") as f:
            state = pickle.load(f)
        self.params = state["params"]
        self.opt_m = state["opt_m"]
        self.opt_v = state["opt_v"]
        self.iteration = state["iteration"]
        self._step_count = state["step_count"]
        self._version = state["version"]
        for r in self._runners:
            _ = r.set_params.remote(self.params, self._version)

    def stop(self) -> None:
        if self._gang is not None:
            self._gang.close()
        for r in self._runners:
            try:
                rt.kill(r)
            except Exception:
                pass    # runner already dead
