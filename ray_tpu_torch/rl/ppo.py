"""PPO: CPU rollout actors + a torch learner on the card.

Counterpart of ``ray_tpu/rl/ppo.py``. Reference: ``rllib/algorithms/ppo/``
driving an EnvRunnerGroup and a LearnerGroup (DDP learner actors)
[UNVERIFIED — mount empty, SURVEY.md §0]. The port's shape:

- experience collection stays on cheap CPU actors (numpy inference),
- the learner is plain torch on the learner's device: GAE as a Python
  loop over T (the reference's reverse ``lax.scan``), advantage
  normalisation, the clipped-surrogate epochs as a loop of gradient steps
  (``torch.func.grad_and_value``), Adam written out. The reference jits
  one program over a ``dp`` mesh of ``learner_devices`` chips (every
  local chip when unset), B sharded over ``dp``, params replicated. The
  port's learner count is the same: ``learner_devices``, else every local
  card on ``"cuda"`` and 1 on ``"cpu"``, lowered until it divides the
  batch's env count. One learner runs in the driver (the process that
  owns the card). Above one, the learner is a gang of ranks
  (``DPUpdate``: ``LocalRanks``, NCCL on the cards, gloo on the CPU):
  rank r takes block r of B, runs GAE on its columns, normalises with the
  population moments of all T x B advantages (two ``psum``s), and averages
  each epoch's gradient over ``dp`` (``pmean``) before an Adam step that
  every rank takes alike.

Resource gang: a placement group reserves one CPU bundle per runner
plus a learner bundle (GPU when available) — RLlib's heterogeneous
rollout/learner shape via gang scheduling.

Torch is imported inside the functions that use it: runner actors import
this package in process workers, which must not pay torch's import.
"""

from __future__ import annotations

import os
import pickle
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rl.config import AlgorithmConfigBase
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.env_runner import EnvRunnerGroup


# --------------------------------------------------------------------------
# policy/value network


def init_policy_params(generator, obs_dim: int, num_actions: int,
                       hidden: int = 64) -> Dict[str, np.ndarray]:
    """The policy/value parameters as fp32 numpy arrays, drawn from the
    CPU ``torch.Generator`` ``generator`` (the reference's keys k1..k6 in
    order: w1, w2, wp, vw1, vw2, wv)."""
    import torch

    def dense(fan_in, shape):
        return np.asarray(torch.randn(shape, generator=generator).numpy()
                          / np.sqrt(fan_in), np.float32)

    # Separate policy/value trunks: the value target scale (episode
    # returns, O(100)) would otherwise swamp the policy gradient
    # through a shared trunk.
    return {
        "w1": dense(obs_dim, (obs_dim, hidden)),
        "b1": np.zeros(hidden, np.float32),
        "w2": dense(hidden, (hidden, hidden)),
        "b2": np.zeros(hidden, np.float32),
        "wp": dense(hidden, (hidden, num_actions)) * 0.01,
        "bp": np.zeros(num_actions, np.float32),
        "vw1": dense(obs_dim, (obs_dim, hidden)),
        "vb1": np.zeros(hidden, np.float32),
        "vw2": dense(hidden, (hidden, hidden)),
        "vb2": np.zeros(hidden, np.float32),
        "wv": dense(hidden, (hidden, 1)) * 0.1,
        "bv": np.zeros(1, np.float32),
    }


def _net(params, obs):
    import torch
    h = torch.tanh(obs @ params["w1"] + params["b1"])
    h = torch.tanh(h @ params["w2"] + params["b2"])
    logits = h @ params["wp"] + params["bp"]
    hv = torch.tanh(obs @ params["vw1"] + params["vb1"])
    hv = torch.tanh(hv @ params["vw2"] + params["vb2"])
    value = (hv @ params["wv"] + params["bv"])[..., 0]
    return logits, value


def _log_probs(logits, actions):
    """(log-softmax over the actions, the log-prob of ``actions``)."""
    import torch
    logp_all = torch.log_softmax(logits, dim=-1)
    return logp_all, torch.gather(logp_all, -1, actions[..., None])[..., 0]


def _entropy(logp_all):
    import torch
    return -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))


# --------------------------------------------------------------------------
# the learner: plain torch functions on the learner's device


def adam(p, m, v, g, t: int, lr: float):
    """One Adam step at step count ``t`` (from 1) on dicts of tensors:
    b1 0.9, b2 0.999, eps 1e-8, the bias terms (1 - b**t) in fp32."""
    import torch
    b1, b2, eps = 0.9, 0.999, 1e-8
    c1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
    c2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))
    m = {k: b1 * m[k] + (1 - b1) * g[k] for k in m}
    v = {k: b2 * v[k] + (1 - b2) * g[k] ** 2 for k in v}
    p = {k: p[k] - lr * (m[k] / c1) / (torch.sqrt(v[k] / c2) + eps)
         for k in p}
    return p, m, v


def gae(rewards, values, last_v, not_done, gamma: float, lam: float):
    """GAE advantages [T, B] by the reverse recursion over T."""
    import torch
    adv_next, v_next = torch.zeros_like(last_v), last_v
    advs = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        delta = rewards[t] + gamma * v_next * not_done[t] - values[t]
        adv_next = delta + gamma * lam * not_done[t] * adv_next
        v_next = values[t]
        advs[t] = adv_next
    return torch.stack(advs)


def _ppo_loss(params, obs, actions, old_logp, adv, ret, clip, vf_coeff,
              entropy_coeff):
    import torch
    logits, value = _net(params, obs)
    logp_all, logp = _log_probs(logits, actions)
    ratio = torch.exp(logp - old_logp)
    clipped = torch.clamp(ratio, 1 - clip, 1 + clip)
    pg_loss = -torch.mean(torch.minimum(ratio * adv, clipped * adv))
    vf_loss = torch.mean((value - ret) ** 2)
    return pg_loss + vf_coeff * vf_loss - entropy_coeff * _entropy(logp_all)


def ppo_update(params, opt_m, opt_v, obs, actions, old_logp, rewards,
               dones, last_obs, t0: int, *, lr, gamma, lam, clip, epochs,
               vf_coeff, entropy_coeff):
    """The reference's jitted update on tensors: GAE from the current
    values, normalised advantages, ``epochs`` Adam steps of the clipped
    surrogate at steps ``t0 + 1 .. t0 + epochs``. Returns (params, m, v,
    the last epoch's loss). Pure, so ``torch.func.vmap`` can stack it over
    policies."""
    import torch
    actions = actions.long()
    _, values = _net(params, obs)                    # [T, B]
    _, last_v = _net(params, last_obs)               # [B]
    not_done = 1.0 - dones.float()
    adv = gae(rewards, values, last_v, not_done, gamma, lam)
    ret = adv + values
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    step = torch.func.grad_and_value(_ppo_loss)
    loss = None
    for t in range(epochs):
        grads, loss = step(params, obs, actions, old_logp, adv, ret, clip,
                           vf_coeff, entropy_coeff)
        params, opt_m, opt_v = adam(params, opt_m, opt_v, grads,
                                    t0 + t + 1, lr)
    return params, opt_m, opt_v, loss


def to_device(tree, device):
    """Numpy arrays (in dicts, lists and tuples) as tensors on
    ``device``."""
    import torch
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return torch.tensor(np.asarray(tree), device=device)


def to_numpy(tree):
    """Tensors (in dicts, lists and tuples) as numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()


def learner_count(device, learner_devices: Optional[int],
                  batch_envs: int) -> int:
    """The learner's device count, as the reference picks its ``dp``:
    ``learner_devices``, else every local card on ``"cuda"`` and 1 on
    ``"cpu"``, lowered until it divides ``batch_envs``. More devices than
    the host has (cards on ``"cuda"``, cores on ``"cpu"``) raise
    ``ValueError``, as the reference's ``make_mesh`` does."""
    import torch
    on_card = torch.device(device).type == "cuda"
    have = torch.cuda.device_count() if on_card else (os.cpu_count() or 1)
    n = learner_devices or (have if on_card else 1)
    while n > 1 and batch_envs % n != 0:
        n -= 1
    if n > 1 and n > have:
        raise ValueError(
            f"learner_devices={learner_devices}: a learner over {n} "
            f"{'cards' if on_card else 'CPU ranks'}, the host has {have}")
    return max(n, 1)


def learner_device(device, learner_devices: Optional[int] = None,
                   batch_envs: int = 1):
    """(the learner's ``torch.device``, its device count): the count from
    ``learner_count``, checked before the device, so that a count the host
    lacks raises ``ValueError`` with or without a card."""
    n = learner_count(device, learner_devices, batch_envs)
    return resolve_device(device), n


def ppo_hyper(config) -> Dict:
    """The update's hyperparameters from a PPO-style config."""
    return dict(lr=config.lr, gamma=config.gamma, lam=config.lam,
                clip=config.clip, epochs=config.epochs,
                vf_coeff=config.vf_coeff,
                entropy_coeff=config.entropy_coeff)


def make_update(config: "PPOConfig", device="cuda", learners: int = 1):
    """The update on ``device`` as a function of numpy arrays, with the
    signature of the reference's jitted update: (params, opt_m, opt_v,
    obs, actions, old_logp, rewards, dones, last_obs, t0) -> (params,
    opt_m, opt_v, loss), all numpy. ``learners`` above 1: the gang's
    update, ``make_dp_update``."""
    if learners > 1:
        return make_dp_update(config, learners, device)
    dev = resolve_device(device)
    hyper = ppo_hyper(config)

    def update(params, opt_m, opt_v, obs, actions, old_logp, rewards,
               dones, last_obs, t0):
        args = to_device((params, opt_m, opt_v, obs, actions, old_logp,
                          rewards, dones, last_obs), dev)
        return to_numpy(ppo_update(*args, int(t0), **hyper))

    return update


# --------------------------------------------------------------------------
# the learner over a gang of ranks (dp > 1)


def _psum_moments(adv, count):
    """Population mean and std of the advantages of every rank over their
    last two dims (T and B): the sum, then the squared deviations, each
    summed over ``dp``. ``count`` is the global T x B."""
    import torch
    from ray_tpu_torch.collective.xla import psum
    dims = (-2, -1)
    mean = psum(adv.sum(dims), "dp") / count
    mean = mean[..., None, None]
    var = psum(((adv - mean) ** 2).sum(dims), "dp") / count
    return mean, torch.sqrt(var)[..., None, None]


def pmean_tree(grads, loss):
    """``grads`` (a dict of tensors) and ``loss`` averaged over ``dp`` in
    one all-reduce of their concatenation."""
    import torch
    from ray_tpu_torch.collective.xla import pmean
    keys = sorted(grads)
    flat = torch.cat([grads[k].reshape(-1) for k in keys]
                     + [loss.reshape(-1)])
    flat = pmean(flat, "dp")
    out, at = {}, 0
    for k in keys:
        size = grads[k].numel()
        out[k] = flat[at:at + size].view_as(grads[k])
        at += size
    return out, flat[at:].view_as(loss)


def ppo_update_dp(params, opt_m, opt_v, obs, actions, old_logp, rewards,
                  dones, last_obs, t0: int, *, lr, gamma, lam, clip, epochs,
                  vf_coeff, entropy_coeff, stacked: bool = False):
    """``ppo_update`` on one rank of a ``dp`` gang, inside an
    ``axis_env`` of its mesh: the rank's columns of B, GAE on them, the
    advantages normalised by the moments of all ranks' T x B, and each
    epoch's gradient of the rank's local-mean loss averaged over ``dp``
    before the Adam step. ``stacked``: every leaf and batch array has a
    leading policy axis (multi-agent PPO), the per-policy pieces run
    under ``torch.func.vmap`` and the collectives outside it."""
    import torch
    from ray_tpu_torch.collective.xla import axis_size
    actions = actions.long()
    net = torch.func.vmap(_net) if stacked else _net
    _, values = net(params, obs)                     # [(P,) T, b]
    _, last_v = net(params, last_obs)                # [(P,) b]
    not_done = 1.0 - dones.float()

    def one_gae(r, vals, lv, nd):
        return gae(r, vals, lv, nd, gamma, lam)

    adv = (torch.func.vmap(one_gae) if stacked else one_gae)(
        rewards, values, last_v, not_done)
    ret = adv + values
    count = adv.shape[-2] * adv.shape[-1] * axis_size("dp")
    mean, std = _psum_moments(adv, count)
    adv = (adv - mean) / (std + 1e-8)
    step = torch.func.grad_and_value(_ppo_loss)
    if stacked:
        step = torch.func.vmap(step, in_dims=(0,) * 6 + (None,) * 3)
    loss = None
    for t in range(epochs):
        grads, loss = step(params, obs, actions, old_logp, adv, ret, clip,
                           vf_coeff, entropy_coeff)
        grads, loss = pmean_tree(grads, loss)
        params, opt_m, opt_v = adam(params, opt_m, opt_v, grads,
                                    t0 + t + 1, lr)
    return params, opt_m, opt_v, loss


# A rank's mesh, made on its first update and kept for the gang's life.
_dp_mesh = {}


def _dp_rank(update_fn, hyper, lead: int, device_type: str, outputs: int,
             params, opt_m, opt_v, obs, actions, logp, rewards, dones,
             last_obs, t0):
    """One rank's share of a gang update (run by ``DPUpdate`` on every
    rank): its block of B (the columns ``[r B/n, (r+1) B/n)``, the block
    JAX's device r holds) of every batch array, ``update_fn`` inside an
    ``axis_env`` of the ``dp`` mesh, TF32 off. Rank 0 returns the first
    ``outputs`` results as numpy; the others return None."""
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.collective.xla import axis_env
    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, n = dist.get_rank(), dist.get_world_size()
    if device_type not in _dp_mesh:
        _dp_mesh[device_type] = make_mesh(MeshSpec(dp=n), device=device_type)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))

    def block(x, axis):
        b = x.shape[axis] // n
        return np.ascontiguousarray(
            np.take(x, np.arange(rank * b, (rank + 1) * b), axis=axis))

    batch = [block(x, lead + 1) for x in (obs, actions, logp, rewards,
                                          dones)]
    args = to_device((params, opt_m, opt_v, *batch, block(last_obs, lead)),
                     dev)
    with axis_env(_dp_mesh[device_type]):
        out = update_fn(*args, int(t0), **hyper)
    return to_numpy(tuple(out[:outputs])) if rank == 0 else None


class DPUpdate:
    """A learner update over a gang of ``n`` ranks (``LocalRanks(n,
    device)``: NCCL ranks on the cards, gloo ranks on the CPU), started
    here and stopped by ``close``. A call sends params, Adam moments and
    the whole batch to every rank, each rank runs ``update_fn`` on its
    block of B (``_dp_rank``), and rank 0's results come back as numpy.
    B must be divisible by ``n``. ``ranks``: a running ``LocalRanks`` of
    ``n`` ranks to use instead, which ``close`` leaves running."""

    def __init__(self, update_fn, hyper: Dict, n: int, device="cuda",
                 lead: int = 0, outputs: int = 4, ranks=None):
        from ray_tpu_torch.parallel.launch import LocalRanks
        self.n = n
        device_type = resolve_device(device).type
        self._job = (update_fn, hyper, lead, device_type, outputs)
        self._lead = lead
        self._own = ranks is None
        self.ranks = LocalRanks(n, device) if ranks is None else ranks
        if self.ranks.world_size != n:
            raise ValueError(f"{self.ranks.world_size} ranks for a gang "
                             f"of {n}")

    def __call__(self, params, opt_m, opt_v, obs, actions, logp, rewards,
                 dones, last_obs, t0):
        b = obs.shape[self._lead + 1]
        if b % self.n:
            raise ValueError(f"a batch of {b} envs over {self.n} learner "
                             "ranks: B must be divisible by the rank count")
        return self.ranks.run(_dp_rank, *self._job, params, opt_m, opt_v,
                              obs, actions, logp, rewards, dones, last_obs,
                              int(t0))[0]

    def close(self) -> None:
        if self._own:
            self.ranks.close()


def make_dp_update(config: "PPOConfig", n: int, device="cuda",
                   ranks=None) -> DPUpdate:
    """PPO's update over a gang of ``n`` ranks (``ranks``, or new ones),
    with ``make_update``'s signature; ``close()`` stops new ranks."""
    return DPUpdate(ppo_update_dp, ppo_hyper(config), n, device,
                    ranks=ranks)


# --------------------------------------------------------------------------
# config (AlgorithmConfig builder style)


@dataclass
class PPOConfig(AlgorithmConfigBase):
    env: str = "CartPole"
    num_env_runners: int = 2
    num_envs_per_runner: int = 16
    rollout_length: int = 128
    lr: float = 3e-3
    gamma: float = 0.99
    lam: float = 0.95
    clip: float = 0.2
    epochs: int = 8
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    hidden: int = 64
    seed: int = 0
    learner_devices: Optional[int] = None   # None: every local card
    use_placement_group: bool = True
    learner_resources: Dict[str, float] = field(default_factory=dict)
    device: str = "cuda"                    # the learner's device

    def resources(self, *, learner_devices: Optional[int] = None,
                  use_placement_group: Optional[bool] = None,
                  learner_resources: Optional[Dict[str, float]] = None
                  ) -> "PPOConfig":
        if learner_devices is not None:
            self.learner_devices = learner_devices
        if use_placement_group is not None:
            self.use_placement_group = use_placement_group
        if learner_resources is not None:
            self.learner_resources = dict(learner_resources)
        return self

    def build(self) -> "PPO":
        return PPO(self)


# --------------------------------------------------------------------------
# the algorithm


class PPO:
    """Iterative trainer: ``train()`` = collect + one learner update.

    Tune-compatible: train() returns a metrics dict; save()/restore()
    round-trip params + optimizer state.
    """

    def __init__(self, config: PPOConfig):
        import torch
        self.config = config
        self.device, self.learners = learner_device(
            config.device, config.learner_devices,
            config.num_env_runners * config.num_envs_per_runner)
        rt.init()
        probe = make_env(config.env, 1, 0)
        self.obs_dim = probe.obs_dim
        self.num_actions = probe.num_actions

        self._pg = None
        bundle_offset = 0
        if config.use_placement_group:
            from ray_tpu_torch.util.placement_group import placement_group
            learner_bundle = dict(config.learner_resources) or \
                self._default_learner_bundle()
            bundles = [learner_bundle] + \
                [{"CPU": 1.0}] * config.num_env_runners
            self._pg = placement_group(bundles, strategy="PACK")
            rt.get(self._pg.ready(), timeout=120)
            bundle_offset = 1
        self.runners = EnvRunnerGroup(
            config.env, config.num_env_runners, config.num_envs_per_runner,
            seed=config.seed, placement_group=self._pg,
            bundle_offset=bundle_offset)

        self.params = init_policy_params(
            torch.Generator().manual_seed(config.seed), self.obs_dim,
            self.num_actions, config.hidden)
        self.opt_state = {k: np.zeros_like(v)
                          for k, v in self.params.items()}  # adam m
        self.opt_state_v = {k: np.zeros_like(v)
                            for k, v in self.params.items()}  # adam v
        self.iteration = 0
        self._step_count = 0
        self._update = make_update(config, self.device, self.learners)
        # the learner gang, when there is one: stop() closes it
        self._gang = self._update if self.learners > 1 else None
        self._recent_returns: List[float] = []

    @staticmethod
    def _default_learner_bundle() -> Dict[str, float]:
        try:
            avail = rt.cluster_resources()
        except Exception:
            avail = {}
        if avail.get("GPU", 0) >= 1:
            return {"GPU": min(8.0, avail["GPU"]), "CPU": 1.0}
        return {"CPU": 1.0}

    # -- Trainable API -------------------------------------------------

    def train(self) -> Dict:
        cfg = self.config
        t_start = time.perf_counter()
        rollouts = self.runners.collect(self.params, cfg.rollout_length)
        obs = np.concatenate([r["obs"] for r in rollouts], axis=1)
        actions = np.concatenate([r["actions"] for r in rollouts], axis=1)
        logp = np.concatenate([r["logp"] for r in rollouts], axis=1)
        rewards = np.concatenate([r["rewards"] for r in rollouts], axis=1)
        dones = np.concatenate([r["dones"] for r in rollouts], axis=1)
        last_obs = np.concatenate([r["last_obs"] for r in rollouts], axis=0)
        for r in rollouts:
            self._recent_returns.extend(r["episode_returns"].tolist())
        self._recent_returns = self._recent_returns[-100:]

        (self.params, self.opt_state, self.opt_state_v,
         loss) = self._update(self.params, self.opt_state, self.opt_state_v,
                              obs, actions, logp, rewards, dones, last_obs,
                              self._step_count)
        self._step_count += cfg.epochs
        self.iteration += 1

        mean_ret = (float(np.mean(self._recent_returns))
                    if self._recent_returns else 0.0)
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": mean_ret,
            "num_env_steps_sampled": (self.iteration * cfg.rollout_length
                                      * cfg.num_env_runners
                                      * cfg.num_envs_per_runner),
            "loss": float(loss),
            "time_this_iter_s": time.perf_counter() - t_start,
        }

    # -- checkpointing -------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump({"params": self.params,
                         "opt_m": self.opt_state,
                         "opt_v": self.opt_state_v,
                         "iteration": self.iteration,
                         "step_count": self._step_count}, f)

    def restore(self, path: str) -> None:
        with open(path, "rb") as f:
            state = pickle.load(f)
        self.params = state["params"]
        self.opt_state = state["opt_m"]
        self.opt_state_v = state["opt_v"]
        self.iteration = state["iteration"]
        self._step_count = state["step_count"]

    def stop(self) -> None:
        if self._gang is not None:
            self._gang.close()
        self.runners.shutdown()
        if self._pg is not None:
            from ray_tpu_torch.util.placement_group import (
                remove_placement_group)
            try:
                remove_placement_group(self._pg)
            except Exception:
                pass    # group already removed with the cluster
