"""The port's GPipe pipeline (ray_tpu_torch.parallel.pipeline) against the
JAX package's, on the CPU.

The port's side runs on 4 spawned ranks of a gloo process group
(``LocalRanks``, started once for the module); the JAX side on the CPU
devices that conftest.py makes. Both start from the same parameters (JAX's
``init_params``, as numpy) and the same tokens. Config and bounds are
tests/test_pipeline.py's (vocab 64, d32, 4 layers, 2 heads, d_ff 64, fp32,
remat on): the pipelined forward within 2e-4 (abs and rel) of the port's
own ``forward`` and of JAX's ``forward_pipelined`` on the same (pp, M);
at pp = 4 the loss within 1e-4 relative and every gradient leaf within
3e-4 (abs and rel) of the port's single-stage gradients and of JAX's
pipelined ones, on every rank. The port's pp = 2 runs on a (dp 2, pp 2)
mesh, so the replicated dp ranks are driven too.

``make_train_step`` on a mesh with pp > 1: JAX's GSPMD step names pp in no
spec, so its pp ranks compute alike; the port's step is held to JAX's on
the same (pp 2, fsdp 2) mesh, loss and grad norm per step to 1e-5
relative, the bound of tests/test_torch_sharded_training.py.
"""

import functools

import numpy as np
import pytest
import torch

from ray_tpu_torch.parallel.launch import LocalRanks

WORLD = 4
CFG = dict(vocab_size=64, d_model=32, n_layers=4, n_heads=2, n_kv_heads=2,
           d_ff=64, max_seq_len=32)
FWD_TOL = 2e-4
LOSS_REL = 1e-4
GRAD_TOL = 3e-4
STEP_REL = 1e-5
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
N_STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def ranks():
    with LocalRanks(WORLD, device="cpu") as r:
        yield r


def _tokens():
    return np.random.RandomState(1).randint(
        0, CFG["vocab_size"], (8, 16)).astype(np.int32)


def _flat(tree, path=()):
    """{path: leaf} of a tree of dicts and lists, in insertion order (the
    order of ``training.param_leaves``)."""
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items()
                for p, x in _flat(v, path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: x for i, v in enumerate(tree)
                for p, x in _flat(v, path + (i,)).items()}
    return {path: tree}


# ------------------------------------------------------------ rank side

def _port_cfg():
    from ray_tpu_torch.models import TransformerConfig
    return TransformerConfig(**CFG, dtype=torch.float32, remat=True)


def _xent(logits, tokens):
    """tests/test_pipeline.py's loss: next token by a roll of the tokens."""
    targets = torch.roll(tokens.long(), -1, dims=1)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None]).mean()


def _mesh(pp):
    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    return make_mesh(MeshSpec(dp=WORLD // pp, pp=pp), device="cpu")


def _port_forward(pp, microbatches, params, tokens):
    from ray_tpu_torch.models import params_from_jax
    from ray_tpu_torch.parallel.pipeline import forward_pipelined
    p = params_from_jax(params, device="cpu")
    with torch.no_grad():
        return forward_pipelined(p, torch.from_numpy(tokens), _port_cfg(),
                                 _mesh(pp), microbatches).numpy()


def _port_grads(params, tokens):
    """On each rank, at pp = 4 with 4 microbatches: the loss and every
    leaf's gradient, by path."""
    from ray_tpu_torch.models import params_from_jax
    from ray_tpu_torch.models.training import param_leaves
    from ray_tpu_torch.parallel.pipeline import forward_pipelined
    p = params_from_jax(params, device="cpu")
    leaves = param_leaves(p)
    for leaf in leaves:
        leaf.requires_grad_(True)
    toks = torch.from_numpy(tokens)
    loss = _xent(forward_pipelined(p, toks, _port_cfg(), _mesh(4), 4), toks)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), {path: g.numpy()
                         for path, g in zip(_flat(p), grads)}


def _port_refusals(params, tokens):
    from ray_tpu_torch.models import params_from_jax
    from ray_tpu_torch.parallel.pipeline import (
        forward_pipelined, stack_pipeline_blocks)
    p = params_from_jax(params, device="cpu")
    refused = []
    for call in (lambda: forward_pipelined(p, torch.from_numpy(tokens),
                                           _port_cfg(), _mesh(4), 3),
                 lambda: stack_pipeline_blocks(p["blocks"], 3)):
        try:
            call()
        except ValueError as e:
            refused.append(str(e))
    return refused


def _port_steps(params, tokens):
    """On each rank: N_STEPS of the port's sharded step on a (pp 2, fsdp 2)
    mesh from the JAX package's parameters; the losses and grad norms."""
    from ray_tpu_torch.models import (
        TrainState, TransformerConfig, make_optimizer, make_train_step,
        param_specs, shard_params_from_jax)
    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    cfg = TransformerConfig(**CFG, dtype=torch.float32, remat=False)
    mesh = make_mesh(MeshSpec(pp=2, fsdp=2), device="cpu")
    tx = make_optimizer(**OPT)
    p = shard_params_from_jax(params, mesh, param_specs(cfg), device="cpu")
    state = TrainState(step=0, params=p, opt_state=tx.init(p))
    step = make_train_step(cfg, tx, mesh)
    losses, norms = [], []
    for _ in range(N_STEPS):
        state, metrics = step(state, {"tokens": torch.from_numpy(tokens)})
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    return losses, norms


# ------------------------------------------------------------ JAX side

def _jax_cfg(remat=True):
    import jax.numpy as jnp
    from ray_tpu.models.transformer import TransformerConfig
    return TransformerConfig(**CFG, dtype=jnp.float32, remat=remat)


@functools.lru_cache(maxsize=None)
def _jax_params():
    import jax
    from ray_tpu.models.transformer import init_params
    return jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0),
                                                _jax_cfg()))


def _jax_mesh(spec):
    import jax
    from ray_tpu.parallel.mesh import MeshSpec, make_mesh
    spec = MeshSpec(**spec)
    return make_mesh(spec, jax.devices()[:spec.num_devices])


def _jax_xent(logits, tokens):
    import jax
    import jax.numpy as jnp
    targets = jnp.roll(tokens, -1, axis=1)
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, targets[..., None], axis=-1))


def _port_single_stage(params, tokens, grads=False):
    from ray_tpu_torch.models import forward, params_from_jax
    from ray_tpu_torch.models.training import param_leaves
    p = params_from_jax(params, device="cpu")
    toks = torch.from_numpy(tokens)
    if not grads:
        with torch.no_grad():
            return forward(p, toks, _port_cfg()).numpy()
    leaves = param_leaves(p)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = _xent(forward(p, toks, _port_cfg()), toks)
    return loss.item(), {path: g.numpy() for path, g in
                         zip(_flat(p), torch.autograd.grad(loss, leaves))}


@pytest.mark.parametrize("pp,microbatches", [(2, 4), (4, 2), (4, 8)])
def test_pipelined_forward_matches_port_and_jax(ranks, pp, microbatches):
    import jax
    from ray_tpu.parallel.pipeline import forward_pipelined
    params, tokens = _jax_params(), _tokens()
    mesh = _jax_mesh(dict(pp=pp))
    want = np.asarray(jax.jit(lambda p, t: forward_pipelined(
        p, t, _jax_cfg(), mesh, microbatches))(params, tokens))
    single = _port_single_stage(params, tokens)
    for out in ranks.run(_port_forward, pp, microbatches, params, tokens):
        np.testing.assert_allclose(out, want, atol=FWD_TOL, rtol=FWD_TOL)
        np.testing.assert_allclose(out, single, atol=FWD_TOL, rtol=FWD_TOL)


def test_pipelined_gradients_match_single_stage_and_jax(ranks):
    import jax
    import jax.numpy as jnp
    from ray_tpu.parallel.pipeline import forward_pipelined
    params, tokens = _jax_params(), _tokens()
    mesh = _jax_mesh(dict(pp=4))
    toks = jnp.asarray(tokens)
    j_loss, j_grads = jax.jit(jax.value_and_grad(lambda p: _jax_xent(
        forward_pipelined(p, toks, _jax_cfg(), mesh, 4), toks)))(params)
    j_grads = {path: np.asarray(g) for path, g in _flat(j_grads).items()}
    s_loss, s_grads = _port_single_stage(params, tokens, grads=True)
    for loss, grads in ranks.run(_port_grads, params, tokens):
        np.testing.assert_allclose(loss, s_loss, rtol=LOSS_REL)
        np.testing.assert_allclose(loss, float(j_loss), rtol=LOSS_REL)
        assert grads.keys() == s_grads.keys() == j_grads.keys()
        for path, g in grads.items():
            np.testing.assert_allclose(g, s_grads[path], atol=GRAD_TOL,
                                       rtol=GRAD_TOL, err_msg=str(path))
            np.testing.assert_allclose(g, j_grads[path], atol=GRAD_TOL,
                                       rtol=GRAD_TOL, err_msg=str(path))


def test_pipeline_rejects_bad_partitions(ranks):
    for refused in ranks.run(_port_refusals, _jax_params(), _tokens()):
        assert len(refused) == 2, refused
        assert all("not divisible" in m for m in refused), refused


def test_train_step_on_pp_mesh_matches_jax(ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from ray_tpu.models import make_optimizer, make_train_step
    from ray_tpu.models.training import TrainState, state_specs
    from ray_tpu.parallel.mesh import tree_shardings
    params, tokens = _jax_params(), _tokens()
    cfg = _jax_cfg(remat=False)
    mesh = _jax_mesh(dict(pp=2, fsdp=2))
    tx = make_optimizer(**OPT)
    jparams = jax.tree.map(jnp.asarray, params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                       opt_state=tx.init(jparams))
    state = jax.device_put(state, tree_shardings(
        mesh, state_specs(cfg, tx, jparams)))
    toks = jax.device_put(jnp.asarray(tokens),
                          NamedSharding(mesh, JP(("dp", "fsdp"), "sp")))
    step = make_train_step(cfg, tx, mesh, donate=False)
    j_losses, j_norms = [], []
    for _ in range(N_STEPS):
        state, metrics = step(state, {"tokens": toks})
        j_losses.append(float(metrics["loss"]))
        j_norms.append(float(metrics["grad_norm"]))
    for losses, norms in ranks.run(_port_steps, params, tokens):
        np.testing.assert_allclose(losses, j_losses, rtol=STEP_REL, atol=0)
        np.testing.assert_allclose(norms, j_norms, rtol=STEP_REL, atol=0)
