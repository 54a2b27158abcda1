"""The port's sharded train step (ray_tpu_torch.models.training with a
mesh) against the JAX package's, on the CPU.

The port's side runs on 4 spawned ranks of a gloo process group
(``LocalRanks``, a file rendezvous, one torch thread each), started once for
the module; the JAX side on 4 of the 8 CPU devices that conftest.py makes.
Both start from the same parameters: JAX's ``init_state`` on the mesh,
carried to each rank's blocks by ``shard_params_from_jax``. The config is
tests/test_models.py's (vocab 128, d64, 2 layers, GQA 4/2, d_ff 128, fp32)
and so is the batch (4 x 64 tokens).

Bounds, those of tests/test_torch_training.py: loss and grad norm per step
1e-5 relative against JAX's step on the same mesh; parameters after three
steps within twice JAX's own flash-vs-dense gap after the same three steps
of JAX's unsharded dense step, measured here (Adam's first steps turn tiny
differences in near-zero gradients into differences of order lr). JAX's
own sharded step is not that close to its dense one (on tp 2 x sp 2 it is
3.8e-5 away, against a flash-vs-dense gap of 2.2e-5), so against JAX's
sharded step the parameters are held to twice the larger of its two own
gaps.
The sp-mesh loss within 1e-4 of JAX's dense and ring losses
(tests/test_models.py).
"""

import functools

import numpy as np
import pytest
import torch

from ray_tpu_torch.parallel.launch import LocalRanks

WORLD = 4
CFG = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=128, max_seq_len=64)
REL = 1e-5
N_STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


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


def _tokens(b=4, s=64, seed=0):
    return np.random.RandomState(seed).randint(0, 128, (b, s)).astype(
        np.int32)


# ------------------------------------------------------------ rank side

def _port_cfg(**kw):
    from ray_tpu_torch.models import TransformerConfig
    return TransformerConfig(**CFG, dtype=torch.float32, remat=False, **kw)


def _port_steps(spec, params, tokens, n_steps):
    """On each rank: ``n_steps`` of the port's sharded step from the JAX
    package's parameters; the losses, grad norms and the rank's blocks of
    the final parameters."""
    from ray_tpu_torch.models import (
        TrainState, make_optimizer, make_train_step, param_specs,
        shard_params_from_jax)
    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    cfg = _port_cfg()
    mesh = make_mesh(MeshSpec(**spec), device="cpu")
    tx = make_optimizer(**OPT)
    pparams = shard_params_from_jax(params, mesh, param_specs(cfg),
                                    device="cpu")
    state = TrainState(step=0, params=pparams, opt_state=tx.init(pparams))
    step = make_train_step(cfg, tx, mesh)
    batch = {"tokens": torch.from_numpy(tokens)}
    losses, norms = [], []
    for i in range(n_steps):
        state, metrics = step(state, batch)
        assert metrics["step"] == i
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    assert state.step == n_steps
    return losses, norms, _flat(state.params)


def _port_sp_loss(params, tokens):
    """On each rank: the global loss on an sp = 4 mesh (ring attention)."""
    from ray_tpu_torch.collective import xla
    from ray_tpu_torch.models import param_specs, shard_params_from_jax
    from ray_tpu_torch.models.sharded import loss_fn_shard
    from ray_tpu_torch.ops import make_attention_fn
    from ray_tpu_torch.parallel.mesh import DATA_AXES, MeshSpec, make_mesh
    cfg = _port_cfg()
    mesh = make_mesh(MeshSpec.auto(sp=4), device="cpu")
    pparams = shard_params_from_jax(params, mesh, param_specs(cfg),
                                    device="cpu")
    attn = make_attention_fn(mesh, impl="ring")
    with torch.no_grad(), xla.axis_env(mesh):
        loss = loss_fn_shard(pparams, {"tokens": torch.from_numpy(tokens)},
                             cfg, attn)
        return xla.psum(loss, DATA_AXES).item()


def _port_refusals(tokens):
    """On each rank, on a (tp 2, sp 2) mesh: the messages of the refusals
    of attention that stays within each sequence shard (flash and the
    reference through make_train_step, flash through loss_fn_shard); ring
    and Ulysses are taken."""
    from ray_tpu_torch.collective import xla
    from ray_tpu_torch.models import init_state, make_optimizer, \
        make_train_step
    from ray_tpu_torch.models.sharded import loss_fn_shard
    from ray_tpu_torch.ops import flash_attention, make_attention_fn
    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    cfg = _port_cfg()
    mesh = make_mesh(MeshSpec.auto(tp=2, sp=2), device="cpu")
    tx = make_optimizer(**OPT)
    refused = []
    for impl in ("flash", "reference"):
        try:
            make_train_step(cfg, tx, mesh,
                            attn_fn=make_attention_fn(mesh, impl=impl))
        except ValueError as e:
            refused.append(str(e))
    params = init_state(cfg, tx, seed=0, device="cpu", mesh=mesh).params
    try:
        with torch.no_grad(), xla.axis_env(mesh):
            loss_fn_shard(params, {"tokens": torch.from_numpy(tokens)}, cfg,
                          flash_attention)
    except ValueError as e:
        refused.append(str(e))
    for impl in ("ring", "ulysses"):
        make_train_step(cfg, tx, mesh,
                        attn_fn=make_attention_fn(mesh, impl=impl))
    return refused

def _port_learns(tokens):
    """On each rank: 8 steps on a (tp 2, sp 2) mesh from the port's own
    initial state; the losses."""
    from ray_tpu_torch.models import init_state, make_optimizer, \
        make_train_step
    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    cfg = _port_cfg()
    mesh = make_mesh(MeshSpec.auto(tp=2, sp=2), device="cpu")
    tx = make_optimizer(lr=1e-2, total_steps=50)
    state = init_state(cfg, tx, seed=0, device="cpu", mesh=mesh)
    step = make_train_step(cfg, tx, mesh)
    losses = []
    for _ in range(8):
        state, metrics = step(state, {"tokens": torch.from_numpy(tokens)})
        losses.append(metrics["loss"].item())
    return losses


# ------------------------------------------------------------ JAX side

def _jax_mesh(spec):
    import jax
    from ray_tpu.parallel.mesh import MeshSpec, make_mesh
    return make_mesh(MeshSpec(**spec), jax.devices()[:WORLD])


@functools.lru_cache(maxsize=None)
def _jax_params():
    import jax
    import jax.numpy as jnp
    from ray_tpu.models import TransformerConfig, init_params
    cfg = TransformerConfig(**CFG, dtype=jnp.float32, remat=False)
    return jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), cfg))


def _jax_run(params, tokens, mesh=None, use_flash=False):
    """Losses, grad norms and final params (a numpy tree) of the JAX
    package's train step from ``params``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from ray_tpu.models import TransformerConfig, make_optimizer, \
        make_train_step
    from ray_tpu.models.training import TrainState
    cfg = TransformerConfig(**CFG, dtype=jnp.float32, remat=False,
                            use_flash=use_flash)
    tx = make_optimizer(**OPT)
    jparams = jax.tree.map(jnp.asarray, params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                       opt_state=tx.init(jparams))
    step = make_train_step(cfg, tx, mesh, donate=False)
    toks = jnp.asarray(tokens)
    if mesh is not None:
        from ray_tpu.models.training import state_specs
        from ray_tpu.parallel.mesh import tree_shardings
        state = jax.device_put(state, tree_shardings(
            mesh, state_specs(cfg, tx, jparams)))
        toks = jax.device_put(toks, NamedSharding(mesh, JP(("dp", "fsdp"),
                                                           "sp")))
    losses, norms = [], []
    for _ in range(N_STEPS):
        state, metrics = step(state, {"tokens": toks})
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return losses, norms, jax.tree.map(np.asarray, state.params)


def _flat(tree, path=()):
    """{path: numpy leaf} of a tree of dicts and lists (torch or numpy
    leaves), whatever the order of its dicts' keys."""
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items()
                for p, x in _flat(v, path + (k,)).items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return {p: x for i, v in enumerate(tree)
                for p, x in _flat(v, path + (i,)).items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().numpy()
    return {path: tree}


def _blocks(mesh, params, rank):
    """{path: device ``rank``'s block} of every leaf under the JAX
    package's param_specs."""
    import jax
    from jax.sharding import NamedSharding
    from ray_tpu.models.transformer import TransformerConfig, param_specs
    specs = param_specs(TransformerConfig(**CFG))
    out = {}
    for path, x in _flat(params).items():
        spec = specs
        for key in path:
            spec = spec[key]
        arr = jax.device_put(x, NamedSharding(mesh, spec))
        out[path] = np.asarray(next(s for s in arr.addressable_shards
                                    if s.device.id == rank).data)
    return out


def _gap(a, b):
    return max(np.abs(a[p] - b[p]).max() for p in a)


@pytest.fixture(scope="module")
def jax_dense():
    """JAX's unsharded dense run and its own flash-vs-dense parameter gap
    after three steps: the yardstick for parameters."""
    params = _jax_params()
    _, _, dense = _jax_run(params, _tokens())
    _, _, flash = _jax_run(params, _tokens(), use_flash=True)
    return dense, _gap(_flat(dense), _flat(flash))


@pytest.mark.parametrize("spec", [dict(fsdp=2, tp=2), dict(tp=2, sp=2)],
                         ids=["fsdp2_tp2", "tp2_sp2"])
def test_three_steps_match_jax(ranks, spec, jax_dense):
    dense, flash_gap = jax_dense
    params = _jax_params()
    mesh = _jax_mesh(spec)
    j_losses, j_norms, j_params = _jax_run(params, _tokens(), mesh)
    sharded_gap = _gap(_flat(j_params), _flat(dense))
    results = ranks.run(_port_steps, spec, params, _tokens(), N_STEPS)
    for rank, (losses, norms, blocks) in enumerate(results):
        np.testing.assert_allclose(losses, j_losses, rtol=REL, atol=0)
        np.testing.assert_allclose(norms, j_norms, rtol=REL, atol=0)
        want = _blocks(mesh, j_params, rank)
        assert blocks.keys() == want.keys()
        assert all(blocks[p].shape == want[p].shape for p in want)
        gap = _gap(blocks, _blocks(mesh, dense, rank))
        assert gap <= 2 * flash_gap, (rank, gap, flash_gap)
        gap = _gap(blocks, want)
        own = max(flash_gap, sharded_gap)
        assert gap <= 2 * own, (rank, gap, own)


def test_sp_mesh_loss_matches_jax_dense_and_ring(ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from ray_tpu.models import TransformerConfig, loss_fn
    from ray_tpu.ops import make_attention_fn
    from ray_tpu.parallel.mesh import MeshSpec, make_mesh
    cfg = TransformerConfig(**CFG, dtype=jnp.float32)
    params = _jax_params()
    tokens = _tokens()
    dense = float(loss_fn(jax.tree.map(jnp.asarray, params),
                          {"tokens": jnp.asarray(tokens)}, cfg))
    mesh = make_mesh(MeshSpec.auto(WORLD, sp=4), jax.devices()[:WORLD])
    attn = make_attention_fn(mesh, impl="ring")
    toks = jax.device_put(jnp.asarray(tokens),
                          NamedSharding(mesh, JP(("dp", "fsdp"), "sp")))
    with mesh:
        ring = float(jax.jit(lambda p, b: loss_fn(p, b, cfg, attn))(
            params, {"tokens": toks}))
    for port in ranks.run(_port_sp_loss, params, tokens):
        np.testing.assert_allclose(port, dense, rtol=1e-4)
        np.testing.assert_allclose(port, ring, rtol=1e-4)


def test_train_step_learns_on_tp_sp_mesh(ranks):
    results = ranks.run(_port_learns, _tokens())
    for losses in results:
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0], losses
        assert losses == results[0]


def test_sp_mesh_refuses_attention_within_each_shard(ranks):
    """With sp > 1 an attn_fn that is not a shard_map_fn over sp would
    attend within each rank's sequence shard only (JAX's GSPMD step
    attends globally for the same call): the port raises instead."""
    for refused in ranks.run(_port_refusals, _tokens()):
        assert len(refused) == 3, refused
        assert all("attend across the sequence shards" in m
                   for m in refused), refused

def test_step_without_donation_leaves_its_input_state():
    """``donate=False`` updates a copy: the state passed in keeps its step,
    parameters and moments, and the copy equals what the donating step
    makes of the same state."""
    from ray_tpu_torch.models import init_state, make_optimizer, \
        make_train_step
    from ray_tpu_torch.models.training import param_leaves
    cfg = _port_cfg()
    tx = make_optimizer(**OPT)
    batch = {"tokens": torch.from_numpy(_tokens())}
    state = init_state(cfg, tx, seed=0, device="cpu")
    before = [t.detach().clone() for t in param_leaves(state.params)]
    keep = make_train_step(cfg, tx, donate=False)
    new, _ = keep(*keep(state, batch)[:1], batch)  # lr is 0 at step 0
    donated = init_state(cfg, tx, seed=0, device="cpu")
    step = make_train_step(cfg, tx)
    same, _ = step(*step(donated, batch)[:1], batch)
    assert same is donated and new is not state
    assert state.step == 0 and new.step == 2 and state.opt_state.count == 0
    assert all(torch.equal(a, b)
               for a, b in zip(param_leaves(state.params), before))
    assert all(not torch.equal(a, b)
               for a, b in zip(param_leaves(new.params), before))
    assert all(torch.equal(a, b) for a, b in
               zip(param_leaves(new.params), param_leaves(same.params)))
    assert all(not m.any() for m in state.opt_state.mu)
