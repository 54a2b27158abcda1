"""Training step for the flagship transformer, in PyTorch.

Counterpart of ``ray_tpu/models/training.py``: loss, gradients through
autograd (on the card, the attention's go through the flash backward
kernels), then the JAX package's optax chain written out: clip by global
norm, then AdamW on a warmup-cosine schedule.

With a mesh, the state holds each rank's blocks of the parameters and of
Adam's moments (``state_specs``), and the step is one SPMD program per rank
(``models/sharded.py``): the rank's share of the loss on its part of the
batch, its gradients summed over the ranks that hold the same block, the
global norm over every block, and AdamW on the local blocks.

Where a port could quietly part from optax, this one follows it:

- clipping scales by exactly ``max_norm / norm``, and only when
  ``norm >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` divides by
  ``norm + 1e-6`` instead);
- the schedule is 0 at step 0, so the first update moves nothing, weight
  decay included;
- weight decay is decoupled, ``p - lr * (adam + wd * p)``, and applies to
  every parameter, norms included (optax's ``mask=None``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, ClassVar, Dict, List, Sequence, Tuple

import torch

from ray_tpu_torch.collective import xla
from ray_tpu_torch.models import sharded
from ray_tpu_torch.models.transformer import (
    TransformerConfig, init_params, loss_fn, param_specs)
from ray_tpu_torch.parallel.mesh import DATA_AXES, P, tree_map
from ray_tpu_torch.util.tracing import span


def param_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a parameter tree of dicts and lists, in a fixed
    order: the dicts' insertion order, depth first. A spec ``P`` is a
    leaf."""
    if isinstance(tree, dict):
        values = tree.values()
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        values = tree
    else:
        return [tree]
    return [leaf for value in values for leaf in param_leaves(value)]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32, as
    ``optax.global_norm``. A 0-d tensor: reading it waits for the card."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def clip_by_global_norm(tensors: Sequence[torch.Tensor], max_norm: float,
                        norm: torch.Tensor) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: each tensor as it is where ``norm <
    max_norm``, else ``t / norm * max_norm``. ``norm`` is
    ``global_norm(tensors)``."""
    clip = norm >= max_norm
    return [torch.where(clip, t / norm * max_norm, t) for t in tensors]


def warmup_cosine_schedule(peak: float, warmup_steps: int,
                           decay_steps: int) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0.0, peak, warmup_steps,
    decay_steps)``: linear from 0 at step 0 to ``peak`` at
    ``warmup_steps``, then a cosine down to 0 over the ``decay_steps -
    warmup_steps`` steps after it, and 0 from then on."""
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed "
                         f"warmup_steps ({warmup_steps})")

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return peak * step / warmup_steps
        t = min(step - warmup_steps, cosine_steps)
        return peak * 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))

    return schedule


@dataclasses.dataclass
class AdamWState:
    """Updates taken so far, and Adam's moments in ``param_leaves``
    order."""
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.chain(clip_by_global_norm(1.0), adamw(schedule, b1=0.9,
    b2=0.95, eps=1e-8, weight_decay=weight_decay))``, applied in place."""
    schedule: Callable[[int], float]
    weight_decay: float
    b1: ClassVar[float] = 0.9
    b2: ClassVar[float] = 0.95
    eps: ClassVar[float] = 1e-8
    max_norm: ClassVar[float] = 1.0

    def init(self, params) -> AdamWState:
        leaves = param_leaves(params)
        return AdamWState(count=0,
                          mu=[torch.zeros_like(p) for p in leaves],
                          nu=[torch.zeros_like(p) for p in leaves])

    @torch.no_grad()
    def update_(self, params, grads: Sequence[torch.Tensor],
                state: AdamWState, norm: torch.Tensor = None
                ) -> torch.Tensor:
        """Update ``params`` and ``state`` in place from ``grads``, given
        in ``param_leaves(params)`` order. ``norm`` is the gradients'
        global norm, computed here when not given (a sharded step gives
        the norm over every rank's blocks). Returns it."""
        leaves = param_leaves(params)
        if len(grads) != len(leaves):
            raise ValueError(f"{len(grads)} gradients for {len(leaves)} "
                             f"parameters")
        with span("rt.optim.update"):
            if norm is None:
                norm = global_norm(grads)
            grads = clip_by_global_norm(grads, self.max_norm, norm)
            lr = self.schedule(state.count)
            state.count += 1
            bc1 = 1.0 - self.b1 ** state.count
            bc2 = 1.0 - self.b2 ** state.count
            for p, g, mu, nu in zip(leaves, grads, state.mu, state.nu):
                mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
                update = (mu / bc1) / ((nu / bc2).sqrt() + self.eps)
                p.sub_(lr * update.add_(p, alpha=self.weight_decay))
        return norm


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, Any]
    opt_state: AdamWState


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                   warmup_steps: int = 100,
                   total_steps: int = 10_000) -> AdamW:
    """The JAX package's optimizer: clip by global norm 1.0, then AdamW
    (b1 0.9, b2 0.95, eps 1e-8) on a warmup-cosine schedule that peaks at
    ``lr``."""
    sched = warmup_cosine_schedule(lr, warmup_steps,
                                   max(total_steps, warmup_steps + 1))
    return AdamW(schedule=sched, weight_decay=weight_decay)


def spec_leaves(cfg: TransformerConfig, params) -> List[P]:
    """The spec of each leaf of ``params``, in ``param_leaves(params)``
    order (a tree's dicts may come in any key order)."""
    return param_leaves(tree_map(lambda _, spec: spec, params,
                                 param_specs(cfg)))


def sharded_value_and_grad(loss_shard, params, specs, mesh, *args):
    """On each rank of ``mesh``: the global loss ``loss_shard(params,
    *args)`` (a rank's share, as ``sharded.loss_fn_shard`` gives it), its
    gradients for the rank's blocks ``params`` (laid out by the spec tree
    ``specs``), summed over the ranks that hold the same block, and their
    global norm. Every rank gets the same loss and norm."""
    leaves = param_leaves(params)
    leaf_specs = param_leaves(tree_map(lambda _, spec: spec, params, specs))
    with xla.axis_env(mesh):
        loss = loss_shard(params, *args)
        with span("rt.train.backward"):
            grads = torch.autograd.grad(loss, leaves)
        grads = sharded.sync_grads(grads, leaf_specs)
        norm = sharded.global_norm(grads, leaf_specs)
        loss = xla.psum(loss.detach(), DATA_AXES)
    return loss, grads, norm


def state_specs(cfg: TransformerConfig, tx: AdamW,
                params_like=None) -> TrainState:
    """PartitionSpec tree for the full TrainState: Adam's moments shard
    exactly like their params (``mu`` and ``nu`` in the
    ``param_leaves`` order of ``params_like``, else of
    ``param_specs(cfg)``); the step and the update count are
    replicated."""
    del tx
    pspecs = param_specs(cfg)
    leaves = (param_leaves(pspecs) if params_like is None
              else spec_leaves(cfg, params_like))
    return TrainState(step=P(), params=pspecs,
                      opt_state=AdamWState(count=P(), mu=list(leaves),
                                           nu=list(leaves)))


def init_state(cfg: TransformerConfig, tx: AdamW, seed: int = 0, *,
               device="cuda", mesh=None) -> TrainState:
    """Parameters from ``init_params(cfg, seed, device=device,
    mesh=mesh)`` and the optimizer's state for them, at step 0. With a
    mesh, each rank holds its blocks under ``state_specs``, and never the
    full parameter tree."""
    if mesh is not None:
        sharded.check_shardable(cfg, mesh)
    params = init_params(cfg, seed, device=device, mesh=mesh)
    return TrainState(step=0, params=params, opt_state=tx.init(params))


def _copy_state(state: TrainState) -> TrainState:
    def copy(t):
        return t.detach().clone()
    opt = state.opt_state
    return TrainState(step=state.step, params=tree_map(copy, state.params),
                      opt_state=AdamWState(count=opt.count,
                                           mu=[copy(t) for t in opt.mu],
                                           nu=[copy(t) for t in opt.nu]))


def make_train_step(cfg: TransformerConfig, tx: AdamW, mesh=None,
                    attn_fn=None, donate: bool = True,
                    batch_keys: Tuple[str, ...] = ("tokens",)):
    """Returns ``step(state, batch) -> (state, metrics)``: the loss of
    ``batch`` (``tokens`` [B, S], optional ``loss_mask``), its gradients,
    and one update of the optimizer.

    With ``donate`` the step updates ``state`` in place and returns the
    same object: the parameters and the optimizer's moments are
    overwritten, as the JAX package donates them to its jitted step;
    without, it updates a copy. ``metrics`` holds the loss, the gradients'
    global norm before clipping (0-d tensors) and the step number before
    this update.

    With ``mesh`` (a DeviceMesh of ``make_mesh``), ``state`` is a sharded
    state (``init_state(..., mesh=mesh)``), every rank calls the step with
    the same whole ``batch``, whose keys must be ``batch_keys``, and takes
    its part, split over (dp, fsdp) x sp; the metrics are the global loss
    and grad norm, the same on every rank. With sp > 1 and no ``attn_fn``,
    attention is ring attention over sp; an ``attn_fn`` that would attend
    only within each sequence shard is refused. ``attn_fn`` runs on each
    rank's local q, k, v (``models/sharded.py``).
    """
    if mesh is None:
        def loss_and_grads(state, batch):
            leaves = param_leaves(state.params)
            loss = loss_fn(state.params, batch, cfg, attn_fn)
            with span("rt.train.backward"):
                grads = torch.autograd.grad(loss, leaves)
            return loss, grads, None
    else:
        from ray_tpu_torch.ops.ring_attention import make_attention_fn
        from ray_tpu_torch.parallel.mesh import axis_size
        sharded.check_shardable(cfg, mesh)
        if attn_fn is None and axis_size(mesh, "sp") > 1:
            attn_fn = make_attention_fn(mesh, impl="ring")
        elif attn_fn is not None:
            sharded.attention_body(attn_fn, axis_size(mesh, "sp"))

        def loss_and_grads(state, batch):
            if set(batch) != set(batch_keys):
                raise ValueError(f"batch keys {sorted(batch)} are not "
                                 f"batch_keys {sorted(batch_keys)}")
            return sharded_value_and_grad(
                sharded.loss_fn_shard, state.params, param_specs(cfg), mesh,
                batch, cfg, attn_fn)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with span("rt.train.step"):
            if not donate:
                state = _copy_state(state)
            for p in param_leaves(state.params):
                p.requires_grad_(True)
            loss, grads, norm = loss_and_grads(state, batch)
            grad_norm = tx.update_(state.params, grads, state.opt_state,
                                   norm)
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm,
                   "step": state.step}
        state.step += 1
        return state, metrics

    return step
