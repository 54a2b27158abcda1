"""The port's device collectives (ray_tpu_torch.collective.xla) against the
JAX package's under ``jax.shard_map``, on the CPU.

The counterpart of tests/test_collective.py:331-366 (psum, ring_shift,
all_gather then reduce_scatter), plus all_to_all and ppermute, and the
gradients of all_gather, reduce_scatter, all_to_all and ppermute against
``jax.grad`` through ``jax.shard_map``. The port's side runs on 4 spawned
ranks of a gloo process group (``LocalRanks``) on a mesh of fsdp = 4 (and
fsdp 2 x tp 2 for a tuple axis); the JAX side on 4 of conftest.py's 8 CPU
devices. Each rank's loss is the sum of its output block times the matching
block of a fixed cotangent, so the ranks' losses add up to JAX's global
one, and each rank's gradient is its block of JAX's. fp32; bound 1e-6.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.parallel.launch import LocalRanks

WORLD = 4
TOL = 1e-6


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


# The ops under test, by name: (body(x, axis), input shape, out spec of the
# per-shard results). The input is sharded over the axis on dim 0.
def _op(name, xla, axis):
    return {
        "all_gather": lambda x: xla.all_gather(x, axis, gather_axis=0),
        "all_gather_dim1": lambda x: xla.all_gather(x, axis, gather_axis=1),
        "all_gather_stacked": lambda x: xla.all_gather(x, axis, tiled=False),
        "reduce_scatter": lambda x: xla.reduce_scatter(x, axis,
                                                       scatter_axis=0),
        "reduce_scatter_dim1": lambda x: xla.reduce_scatter(x, axis,
                                                            scatter_axis=1),
        "all_to_all": lambda x: xla.all_to_all(x, axis, split_axis=1,
                                               concat_axis=0),
        "ppermute": lambda x: xla.ppermute(x, axis,
                                           [(0, 2), (2, 1), (1, 3), (3, 0)]),
        "ppermute_partial": lambda x: xla.ppermute(x, axis, [(0, 1), (1, 2)]),
        "ring_shift": lambda x: xla.ring_shift(x, axis, shift=1),
    }[name]


OPS = {  # name -> global input shape
    "all_gather": (8, 3), "all_gather_dim1": (8, 3),
    "all_gather_stacked": (8, 3),
    "reduce_scatter": (32, 3), "reduce_scatter_dim1": (8, 12),
    "all_to_all": (8, 12), "ppermute": (8, 3), "ppermute_partial": (8, 3),
    "ring_shift": (8, 3),
}


def _inputs(name, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(*OPS[name]).astype(np.float32)


# ------------------------------------------------------------ rank side

def _port_collectives(x):
    """On each rank: the JAX test's three checks (identity through psum
    and ring_shift, a psum total, all_gather then reduce_scatter)."""
    from ray_tpu_torch.collective import xla
    from ray_tpu_torch.parallel.mesh import MeshSpec, P, make_mesh, shard
    mesh = make_mesh(MeshSpec.auto(WORLD), device="cpu")
    axis = "fsdp"
    xt = torch.from_numpy(x)

    @xla.shard_map_fn(mesh, in_specs=P(axis), out_specs=P(axis))
    def f(shard):
        total = xla.psum(shard.sum(), axis)
        rot = xla.ring_shift(shard, axis, shift=1)
        return shard + 0 * total + 0 * rot

    @xla.shard_map_fn(mesh, in_specs=P(axis), out_specs=P())
    def total_sum(shard):
        return xla.psum(shard.sum(), axis)

    @xla.shard_map_fn(mesh, in_specs=P(axis), out_specs=P(axis))
    def rs(shard):
        g = xla.all_gather(shard, axis, gather_axis=0)
        return xla.reduce_scatter(g, axis, scatter_axis=0) / 4.0

    with xla.axis_env(mesh):
        sizes = (xla.axis_size(axis), xla.axis_index(axis))
        stats = [xla.pmax(torch.tensor(float(sizes[1])), axis).item(),
                 xla.pmin(torch.tensor(float(sizes[1])), axis).item(),
                 xla.pmean(torch.tensor(float(sizes[1])), axis).item()]
        xla.barrier(axis)
    # a DTensor laid out otherwise than in_specs is resharded first
    again = rs(shard(mesh, xt, P())).full_tensor()
    return (f(xt).full_tensor().numpy(), total_sum(xt).to_local().item(),
            rs(xt).full_tensor().numpy(), sizes, stats, again.numpy())


def _port_op(name, axis, x, cotangent):
    """On each rank: the op's output block and the gradient of
    sum(out * cotangent block) for the rank's input block."""
    from ray_tpu_torch.collective import xla
    from ray_tpu_torch.parallel.mesh import (
        MeshSpec, P, local_block, make_mesh)
    spec = {"fsdp": dict(fsdp=4)}.get(axis, dict(fsdp=2, tp=2))
    mesh = make_mesh(MeshSpec(**spec), device="cpu")
    shard = local_block(mesh, torch.from_numpy(x), P(axis)).clone()
    shard.requires_grad_(True)
    with xla.axis_env(mesh):
        out = _op(name, xla, axis)(shard)
    w = local_block(mesh, torch.from_numpy(cotangent), P(axis))
    (g,) = torch.autograd.grad((out * w).sum(), shard)
    return out.detach().numpy(), g.numpy()


# ------------------------------------------------------------ JAX side

def _jax_mesh(**kw):
    import jax
    from ray_tpu.parallel.mesh import MeshSpec, make_mesh
    return make_mesh(MeshSpec(**kw), jax.devices()[:WORLD])


def _block(mesh, x, axis, rank):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as JP
    arr = jax.device_put(x, NamedSharding(mesh, JP(axis)))
    return np.asarray(next(s for s in arr.addressable_shards
                           if s.device.id == rank).data)


def test_collectives_on_mesh_match_jax(ranks):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP
    from ray_tpu.collective import xla as jxla
    mesh = _jax_mesh(fsdp=4)
    axis = "fsdp"
    x = np.arange(16.0, dtype=np.float32).reshape(8, 2)

    @jxla.shard_map_fn(mesh, in_specs=JP(axis), out_specs=JP(axis))
    def rs(shard):
        g = jxla.all_gather(shard, axis, gather_axis=0)
        return jxla.reduce_scatter(g, axis, scatter_axis=0) / 4.0

    @jxla.shard_map_fn(mesh, in_specs=JP(axis), out_specs=JP())
    def total_sum(shard):
        return jxla.psum(jnp.sum(shard), axis)

    want_rs = np.asarray(rs(jnp.asarray(x)))
    want_total = float(total_sum(jnp.asarray(x)))
    for rank, (f, total, rs_out, sizes, stats, again) in enumerate(
            ranks.run(_port_collectives, x)):
        np.testing.assert_allclose(again, want_rs, atol=TOL)
        np.testing.assert_allclose(f, x)
        assert total == want_total == float(np.sum(x))
        np.testing.assert_allclose(rs_out, want_rs, atol=TOL)
        np.testing.assert_allclose(rs_out, x, atol=TOL)
        assert sizes == (WORLD, rank)
        assert stats == [3.0, 0.0, 1.5]


@pytest.mark.parametrize("axis", ["fsdp", ("fsdp", "tp")],
                         ids=["fsdp", "fsdp_tp"])
@pytest.mark.parametrize("name", sorted(OPS))
def test_op_and_gradient_match_jax(ranks, name, axis):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP
    from ray_tpu.collective import xla as jxla
    mesh = (_jax_mesh(fsdp=4) if axis == "fsdp"
            else _jax_mesh(fsdp=2, tp=2))
    x = _inputs(name)
    jbody = _op(name, jxla, axis)
    fn = jax.shard_map(jbody, mesh=mesh, in_specs=JP(axis),
                       out_specs=JP(axis), check_vma=False)
    out = np.asarray(fn(jnp.asarray(x)))
    cotangent = np.random.RandomState(1).randn(*out.shape).astype(np.float32)
    grad = np.asarray(jax.grad(
        lambda a: jnp.sum(fn(a) * cotangent))(jnp.asarray(x)))
    for rank, (got, got_grad) in enumerate(
            ranks.run(_port_op, name, axis, x, cotangent)):
        np.testing.assert_allclose(got, _block(mesh, out, axis, rank),
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got_grad, _block(mesh, grad, axis, rank),
                                   atol=TOL, rtol=TOL)
