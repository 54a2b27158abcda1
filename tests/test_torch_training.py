"""The port's training step (ray_tpu_torch.models.training) against the
JAX package's, on the same parameters and tokens, on the CPU.

Parameters come from the JAX package's ``init_params`` through
``params_from_jax``; the config is the tiny one of ``__graft_entry__.py``
(vocab 256, d128, 2 layers, GQA 8/4, d_ff 352, S 128, batch 2) in fp32.
The JAX side runs its own ``make_train_step`` (flash attention through the
Pallas kernels in interpret mode); the port's side runs the plain forward
and backward that CPU tensors go through.

Bounds: loss and grad norm per step 1e-5 relative (JAX's own flash and
dense losses agree to ~5e-7 here). Parameters after three steps: twice
JAX's own flash-vs-dense parameter gap after the same three steps,
measured in the test, since Adam's first steps turn tiny differences in
near-zero gradients into differences of order lr.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
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
N_STEPS = 3


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


def _jax_run(jcfg, params, batch, n_steps=N_STEPS):
    """Losses, grad norms and final params of the JAX package's own
    train step, from ``params`` (numpy)."""
    tx = jtr.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=10)
    params = jax.tree.map(jnp.asarray, params)
    state = jtr.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params))
    step = jtr.make_train_step(jcfg, tx, donate=False,
                               batch_keys=tuple(batch))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses, norms = [], []
    for _ in range(n_steps):
        state, metrics = step(state, jbatch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return losses, norms, jax.tree.map(np.asarray, state.params)


def _port_run(pcfg, params, batch, n_steps=N_STEPS):
    tx = ptr.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=10)
    pparams = params_from_jax(params, device="cpu")
    state = ptr.TrainState(step=0, params=pparams,
                           opt_state=tx.init(pparams))
    step = ptr.make_train_step(pcfg, tx)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses, norms, steps = [], [], []
    for _ in range(n_steps):
        state, metrics = step(state, tbatch)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        steps.append(metrics["step"])
    assert steps == list(range(n_steps)) and state.step == n_steps
    return losses, norms, state.params


def _max_param_gap(a, b):
    """Largest absolute difference over every parameter of two trees, the
    one of torch tensors or numpy arrays, the other of numpy arrays."""
    def leaves(tree):
        return [np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
                for x in jax.tree.leaves(tree)]
    return max(np.abs(x - y).max() for x, y in zip(leaves(a), leaves(b)))


@pytest.fixture(scope="module")
def jax_dense_run():
    """JAX's own dense-attention run: the yardstick for parameters."""
    jcfg = jt.TransformerConfig(**TINY, dtype=jnp.float32, remat=False)
    params = _jax_params(jcfg)
    return params, _jax_run(jcfg, params, {"tokens": _tokens()})


@pytest.mark.parametrize("remat", [False, True])
def test_three_steps_match_jax(remat, jax_dense_run):
    params, (_, _, dense_params) = jax_dense_run
    jcfg = jt.TransformerConfig(**TINY, dtype=jnp.float32, remat=remat,
                                use_flash=True)
    pcfg = pt.TransformerConfig(**TINY, dtype=torch.float32, remat=remat,
                                use_flash=True)
    batch = {"tokens": _tokens()}
    j_losses, j_norms, j_params = _jax_run(jcfg, params, batch)
    p_losses, p_norms, p_params = _port_run(pcfg, params, batch)
    np.testing.assert_allclose(p_losses, j_losses, rtol=REL, atol=0)
    np.testing.assert_allclose(p_norms, j_norms, rtol=REL, atol=0)
    # step 0 has lr 0, so the first two losses are equal; later ones fall
    assert p_losses[1] == pytest.approx(p_losses[0], rel=1e-6)
    assert p_losses[2] < p_losses[1]
    own_gap = _max_param_gap(j_params, dense_params)
    assert own_gap > 0
    assert _max_param_gap(p_params, j_params) <= 2 * own_gap
