"""Parts of the port's training step (ray_tpu_torch.models.training)
against the JAX package's, on the CPU: the optimizer's rules against
optax (schedule, clipping, decoupled weight decay), a step with a
``loss_mask``, and the gradients of a mixture-of-experts model.

The full three-step comparison is tests/test_torch_training.py; the
config here is the same tiny one, in fp32. Bounds are stated per test.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

jt = importlib.import_module("ray_tpu.models.transformer")
jtr = importlib.import_module("ray_tpu.models.training")
pt = importlib.import_module("ray_tpu_torch.models.transformer")
ptr = importlib.import_module("ray_tpu_torch.models.training")
from ray_tpu_torch.models import params_from_jax  # noqa: E402

TINY = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=8,
            n_kv_heads=4, d_ff=352, max_seq_len=128)
REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _tokens(seed=1, b=2, s=128):
    return np.random.RandomState(seed).randint(0, 256, (b, s)).astype(
        np.int32)


def _jax_params(jcfg):
    return jax.tree.map(np.asarray,
                        jt.init_params(jax.random.PRNGKey(0), jcfg))


def _jax_step(jcfg, params, batch):
    """Loss and grad norm of one step of the JAX package's own train
    step, from ``params`` (numpy)."""
    tx = jtr.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=10)
    params = jax.tree.map(jnp.asarray, params)
    state = jtr.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params))
    step = jtr.make_train_step(jcfg, tx, donate=False,
                               batch_keys=tuple(batch))
    _, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(metrics["loss"]), float(metrics["grad_norm"])


def _port_step(pcfg, params, batch):
    tx = ptr.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=10)
    pparams = params_from_jax(params, device="cpu")
    state = ptr.TrainState(step=0, params=pparams,
                           opt_state=tx.init(pparams))
    _, metrics = ptr.make_train_step(pcfg, tx)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert metrics["step"] == 0 and state.step == 1
    return metrics["loss"].item(), metrics["grad_norm"].item()


def test_loss_mask_step_matches_jax():
    """One step with a ``loss_mask`` in the batch (dense attention on both
    sides, so the JAX side compiles no Pallas kernel)."""
    jcfg = jt.TransformerConfig(**TINY, dtype=jnp.float32, remat=False)
    pcfg = pt.TransformerConfig(**TINY, dtype=torch.float32, remat=False)
    params = _jax_params(jcfg)
    mask = (np.random.RandomState(4).rand(2, 128) > 0.3).astype(np.float32)
    batch = {"tokens": _tokens(3), "loss_mask": mask}
    j_loss, j_norm = _jax_step(jcfg, params, batch)
    p_loss, p_norm = _port_step(pcfg, params, batch)
    assert p_loss == pytest.approx(j_loss, rel=REL)
    assert p_norm == pytest.approx(j_norm, rel=REL)


def test_moe_loss_gradients_match_jax():
    """fp32 gradients of ``loss_fn`` with a mixture-of-experts MLP (the
    counterpart of tests/test_models.py's MoE gradient check). Bound: each
    gradient within 1e-4 of JAX's in relative norm."""
    kw = dict(TINY, use_moe=True, n_experts=4, expert_top_k=2)
    jcfg = jt.TransformerConfig(**kw, dtype=jnp.float32)
    pcfg = pt.TransformerConfig(**kw, dtype=torch.float32)
    params = _jax_params(jcfg)
    tokens = _tokens(5, s=32)
    j_loss, j_grads = jax.jit(jax.value_and_grad(jt.loss_fn),
                              static_argnums=2)(
        jax.tree.map(jnp.asarray, params), {"tokens": jnp.asarray(tokens)},
        jcfg)
    pparams = params_from_jax(params, device="cpu")
    leaves = jax.tree.leaves(pparams)     # in the order of JAX's leaves
    for p in leaves:
        p.requires_grad_(True)
    p_loss = pt.loss_fn(pparams, {"tokens": torch.from_numpy(tokens)}, pcfg)
    p_grads = torch.autograd.grad(p_loss, leaves)
    assert p_loss.item() == pytest.approx(float(j_loss), rel=REL)
    j_leaves = [np.asarray(g) for g in jax.tree.leaves(j_grads)]
    assert len(j_leaves) == len(p_grads) == 3 + 2 * 10
    for g, w in zip(p_grads, j_leaves):
        assert np.isfinite(g.numpy()).all()
        err = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert err <= 1e-4, err


@pytest.mark.parametrize("warmup,total", [(2, 10), (100, 1000)])
def test_schedule_matches_optax(warmup, total):
    """0 at step 0, linear to the peak, cosine to 0, 0 past the end."""
    lr = 3e-4
    sched = ptr.make_optimizer(lr=lr, warmup_steps=warmup,
                               total_steps=total).schedule
    steps = np.arange(total + 2)
    want = np.asarray(optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup, max(total, warmup + 1))(steps))
    got = np.array([sched(int(s)) for s in steps])
    assert got[0] == 0.0 and got[warmup] == lr and got[-1] == 0.0
    # optax evaluates in fp32: a few of its ulps at the peak
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=lr * 1e-6)


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
    """Below the threshold the gradients pass as they are; above it each
    is scaled by exactly max_norm / norm, with no epsilon."""
    rs = np.random.RandomState(6)
    grads = [rs.standard_normal(shape).astype(np.float32) * scale
             for shape in ((7, 5), (3,), (2, 3, 4))]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    tgrads = [torch.from_numpy(g) for g in grads]
    norm = ptr.global_norm(tgrads)
    np.testing.assert_allclose(
        norm.item(), float(optax.global_norm([jnp.asarray(g)
                                              for g in grads])), rtol=1e-6)
    got = ptr.clip_by_global_norm(tgrads, 1.0, norm)
    for g, w, raw in zip(got, want, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)
        if scale < 1:
            np.testing.assert_array_equal(g.numpy(), raw)


def test_adamw_update_matches_optax_chain():
    """Three updates of the port's optimizer against the JAX package's
    optax chain on the same parameters and gradients: decoupled weight
    decay on every parameter, bias-corrected moments, lr 0 at step 0."""
    rs = np.random.RandomState(7)
    params = {"w": rs.standard_normal((6, 4)).astype(np.float32),
              "norm": np.ones(4, np.float32)}
    grads = [[rs.standard_normal(p.shape).astype(np.float32) * s
              for p in params.values()] for s in (0.5, 2.0, 0.05)]
    jtx = jtr.make_optimizer(lr=1e-2, warmup_steps=1, total_steps=5)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jparams)
    tx = ptr.make_optimizer(lr=1e-2, warmup_steps=1, total_steps=5)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = tx.init(tparams)
    for i, g in enumerate(grads):
        jg = dict(zip(params, (jnp.asarray(x) for x in g)))
        updates, jstate = jtx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        norm = tx.update_(tparams, [torch.from_numpy(x) for x in g], tstate)
        assert norm.item() == pytest.approx(
            float(optax.global_norm(jg)), rel=1e-6)
        for k in params:
            np.testing.assert_allclose(tparams[k].numpy(),
                                       np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-7)
        if i == 0:   # lr 0 at step 0: nothing moved, decay included
            for k in params:
                np.testing.assert_array_equal(tparams[k].numpy(), params[k])
    assert tstate.count == len(grads)


def test_train_step_updates_in_place():
    """The step returns the state it was given, with its parameters
    overwritten in place (the JAX package donates them instead)."""
    pcfg = pt.TransformerConfig(**dict(TINY, n_layers=1),
                                dtype=torch.float32, remat=False)
    tx = ptr.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=10)
    state = ptr.init_state(pcfg, tx, seed=0, device="cpu")
    wq = state.params["blocks"][0]["wq"]
    before = wq.detach().clone()
    step = ptr.make_train_step(pcfg, tx)
    batch = {"tokens": torch.from_numpy(_tokens(8, s=16))}
    for _ in range(2):
        new_state, _ = step(state, batch)
        assert new_state is state
    assert state.params["blocks"][0]["wq"] is wq
    assert not torch.equal(wq.detach(), before)
