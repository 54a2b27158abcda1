"""The port's sequence-parallel attention (ring, Ulysses) and
expert-parallel MoE against the JAX package's, on the CPU.

Counterparts of tests/test_attention.py:110-170, at sp = 4 on 4 ranks (the
JAX tests take 8 devices; here the JAX side runs on 4 of conftest.py's 8
CPU devices). The port's side runs on 4 spawned ranks of a gloo process
group (``LocalRanks``), started once for the module; inputs are numpy
arrays made from a seed. Bounds are the JAX package's own: 2e-5 on
outputs, 2e-4 on gradients, 1e-5 on MoE outputs (and on its gradients).
"""

import functools

import numpy as np
import pytest
import torch

from ray_tpu_torch.parallel.launch import LocalRanks

WORLD = 4
SEQ_SPEC = (("dp", "fsdp"), "sp", "tp", None)


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


def _qkv(b=2, s=256, n=4, h=32, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, s, n, h).astype(np.float32) for _ in range(3))


# ------------------------------------------------------------ rank side

def _port_attention(mesh_kw, impl, causal, qkv, inner=None, grads=False):
    """On each rank: this rank's block of the attention output and, with
    ``grads``, of the gradients of sum(out ** 2) for q, k, v."""
    from ray_tpu_torch.collective import xla
    from ray_tpu_torch.ops import make_attention_fn, ulysses_attention_shard
    from ray_tpu_torch.parallel.mesh import (
        MeshSpec, P, local_block, make_mesh, to_global)
    mesh = make_mesh(MeshSpec.auto(**mesh_kw), device="cpu")
    spec = P(*SEQ_SPEC)
    if inner is None:
        attn = make_attention_fn(mesh, impl=impl, causal=causal)
    else:
        attn = xla.shard_map_fn(mesh, (spec,) * 3, spec)(functools.partial(
            ulysses_attention_shard, axis_name="sp", causal=causal,
            inner=inner))
    local = [local_block(mesh, torch.from_numpy(x), spec).clone()
             .requires_grad_(grads) for x in qkv]
    out = attn(*(to_global(mesh, x, spec) for x in local)).to_local()
    if not grads:
        return out.detach().numpy()
    g = torch.autograd.grad((out ** 2).sum(), local)
    return out.detach().numpy(), [x.numpy() for x in g]


def _moe_inputs(seed=0):
    rng = np.random.RandomState(seed)
    t, d, f, e = 64, 16, 32, 4
    return (rng.randn(t, d).astype(np.float32),
            (rng.randn(d, e) * 0.1).astype(np.float32),
            *((rng.randn(*shape) * 0.1).astype(np.float32)
              for shape in ((e, d, f), (e, d, f), (e, f, d))))


def _port_moe(inputs, n_experts, top_k):
    """On each rank: the single-shard MoE (axis_name=None), the rank's
    block of the expert-parallel one over fsdp = 4, and the gradients of
    sum(out ** 2) through the expert-parallel one: h's and the expert
    tables' blocks, the router's summed over the ranks."""
    import torch.distributed as dist
    from ray_tpu_torch.ops import make_moe_fn, moe_mlp_shard
    from ray_tpu_torch.parallel.mesh import (
        MeshSpec, P, local_block, make_mesh, to_global)
    tensors = [torch.from_numpy(x) for x in inputs]
    local = moe_mlp_shard(*tensors, axis_name=None, n_experts=n_experts,
                          top_k=top_k, capacity_factor=float(n_experts))
    mesh = make_mesh(MeshSpec.auto(), device="cpu")
    moe_fn, ep = make_moe_fn(mesh, n_experts=n_experts, top_k=top_k,
                             capacity_factor=float(n_experts))
    tok, rep, ew = (P(("dp", "fsdp", "sp"), None), P(None, None),
                    P(("dp", "fsdp", "sp"), None, None))
    specs = (tok, rep, ew, ew, ew)
    blocks = [local_block(mesh, x, s).clone().requires_grad_()
              for x, s in zip(tensors, specs)]
    out = moe_fn(*(to_global(mesh, x, s)
                   for x, s in zip(blocks, specs))).to_local()
    grads = list(torch.autograd.grad((out ** 2).sum(), blocks))
    dist.all_reduce(grads[1])  # the replicated router's
    return (ep, local.detach().numpy(), out.detach().numpy(),
            [g.numpy() for g in grads])


# ------------------------------------------------------------ JAX side

def _jax_mesh(**kw):
    import jax
    from ray_tpu.parallel.mesh import MeshSpec, make_mesh
    return make_mesh(MeshSpec.auto(WORLD, **kw), jax.devices()[:WORLD])


def _block(mesh, x, spec, rank):
    """Device ``rank``'s block of ``x`` under ``spec``."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as JP
    arr = jax.device_put(x, NamedSharding(mesh, JP(*spec)))
    return np.asarray(next(s for s in arr.addressable_shards
                           if s.device.id == rank).data)


def _jax_attention(mesh, impl, causal, qkv):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from ray_tpu.ops import make_attention_fn
    shard = NamedSharding(mesh, JP(*SEQ_SPEC))
    args = [jax.device_put(jnp.asarray(x), shard) for x in qkv]
    return np.asarray(jax.jit(make_attention_fn(mesh, impl=impl,
                                                causal=causal))(*args))


def _dense(qkv, causal):
    import jax.numpy as jnp
    from ray_tpu.ops import mha_reference
    return np.asarray(mha_reference(*(jnp.asarray(x) for x in qkv),
                                    causal=causal))


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [True, False])
def test_sequence_parallel_matches_jax(ranks, impl, causal):
    qkv = _qkv()
    mesh = _jax_mesh(sp=4)
    want = _jax_attention(mesh, impl, causal, qkv)
    dense = _dense(qkv, causal)
    for rank, got in enumerate(ranks.run(_port_attention, {"sp": 4}, impl,
                                         causal, qkv)):
        for ref in (want, dense):
            np.testing.assert_allclose(got, _block(mesh, ref, SEQ_SPEC, rank),
                                       atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_flash_inner_matches_dense(ranks, causal):
    """Ulysses with ``inner="flash"``: on CPU tensors the flash path is the
    plain version of the kernels."""
    qkv = _qkv()
    mesh = _jax_mesh(sp=4)
    dense = _dense(qkv, causal)
    for rank, got in enumerate(ranks.run(_port_attention, {"sp": 4},
                                         "ulysses", causal, qkv, "flash")):
        np.testing.assert_allclose(got, _block(mesh, dense, SEQ_SPEC, rank),
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("mesh_kw", [{"sp": 4}, {"tp": 2, "sp": 2}],
                         ids=["sp4", "tp2_sp2"])
def test_ring_attention_gradients_match_jax(ranks, mesh_kw):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from ray_tpu.ops import make_attention_fn, mha_reference
    qkv = _qkv(s=128)
    mesh = _jax_mesh(**mesh_kw)
    shard = NamedSharding(mesh, JP(*SEQ_SPEC))
    args = [jax.device_put(jnp.asarray(x), shard) for x in qkv]
    attn = make_attention_fn(mesh, impl="ring", causal=True)
    out = np.asarray(jax.jit(attn)(*args))
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(attn(q, k, v) ** 2),
                             argnums=(0, 1, 2)))(*args)
    dense = jax.grad(
        lambda q, k, v: jnp.sum(mha_reference(q, k, v, causal=True) ** 2),
        argnums=(0, 1, 2))(*(jnp.asarray(x) for x in qkv))
    results = ranks.run(_port_attention, mesh_kw, "ring", True, qkv, None,
                        True)
    for rank, (got, got_grads) in enumerate(results):
        np.testing.assert_allclose(got, _block(mesh, out, SEQ_SPEC, rank),
                                   atol=2e-5, rtol=2e-5)
        for g, w, d in zip(got_grads, grads, dense):
            for ref in (w, d):
                np.testing.assert_allclose(
                    g, _block(mesh, np.asarray(ref), SEQ_SPEC, rank),
                    atol=2e-4, rtol=2e-4)


def test_moe_expert_parallel_matches_local_and_jax(ranks):
    """EP dispatch over the mesh == the same routing on one shard (high
    capacity, so nothing drops), and both equal the JAX package's; the
    expert-parallel gradients equal ``jax.grad`` of JAX's single-shard
    MoE."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.ops.moe import moe_mlp_shard
    e, k = 4, 2
    inputs = _moe_inputs()
    args = [jnp.asarray(x) for x in inputs]

    def jax_local(*a):
        return moe_mlp_shard(*a, axis_name=None, n_experts=e, top_k=k,
                             capacity_factor=float(e))
    want = np.asarray(jax_local(*args))
    want_grads = jax.grad(lambda *a: jnp.sum(jax_local(*a) ** 2),
                          argnums=tuple(range(5)))(*args)
    mesh = _jax_mesh()
    tok, ew = (("dp", "fsdp", "sp"), None), (("dp", "fsdp", "sp"), None, None)
    specs = (tok, (None, None), ew, ew, ew)
    for rank, (ep, local, dist_out, grads) in enumerate(
            ranks.run(_port_moe, inputs, e, k)):
        assert ep == WORLD
        np.testing.assert_allclose(local, want, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(dist_out, _block(mesh, want, tok, rank),
                                   atol=1e-5, rtol=1e-5)
        for g, w, spec in zip(grads, want_grads, specs):
            np.testing.assert_allclose(
                g, _block(mesh, np.asarray(w), spec, rank),
                atol=1e-5, rtol=1e-5)
