"""The port's mesh layer (ray_tpu_torch.parallel.mesh) and sharding specs
against the JAX package's, on the CPU.

``MeshSpec`` and its helpers, ``param_specs`` and ``state_specs`` are held
equal to JAX's, spec for spec. The blocks that ``shard`` and
``shard_params_from_jax`` give each rank are held equal to JAX's
``addressable_shards`` on the same (fsdp 2, tp 2) mesh: the port's side runs
on 4 spawned ranks of a gloo process group (``LocalRanks``), the JAX side on
4 of conftest.py's 8 CPU devices. Blocks are copies, so equality is exact.
"""

import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.parallel import mesh as pm
from ray_tpu_torch.parallel.launch import LocalRanks

WORLD = 4
CFG = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=128, max_seq_len=64)
SPECS = [(), (None, None), ("fsdp", None), (None, "tp"), ("fsdp", "tp"),
         ("tp", "fsdp"), (("fsdp", "tp"), None), (None, ("fsdp", "tp"))]


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


def _as_tuple(spec):
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)


def _flat_specs(tree, path=()):
    """{path: spec as a tuple} of a spec tree of dicts and lists."""
    from jax.sharding import PartitionSpec as JP
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items()
                for p, s in _flat_specs(v, path + (k,)).items()}
    if isinstance(tree, list):
        return {p: s for i, v in enumerate(tree)
                for p, s in _flat_specs(v, path + (i,)).items()}
    assert isinstance(tree, (pm.P, JP)), tree
    return {path: _as_tuple(tree)}


@pytest.mark.parametrize("n,kw", [(8, {}), (8, {"tp": 2}),
                                  (8, {"tp": 2, "sp": 2}), (4, {"sp": 4}),
                                  (8, {"pp": 2, "tp": 2}), (1, {})])
def test_meshspec_matches_jax(n, kw):
    from ray_tpu.parallel import mesh as jm
    got, want = pm.MeshSpec.auto(n, **kw), jm.MeshSpec.auto(n, **kw)
    assert got == pm.MeshSpec(**{f: getattr(want, f) for f in pm.AXES})
    assert got.num_devices == want.num_devices == n
    assert got.axis_sizes() == want.axis_sizes()
    assert list(got.axis_sizes()) == list(want.axis_sizes())


def test_mesh_constants_match_jax():
    from ray_tpu.parallel import mesh as jm
    assert pm.AXES == jm.AXES
    assert pm.BATCH_AXES == jm.BATCH_AXES and pm.DATA_AXES == jm.DATA_AXES
    assert _as_tuple(pm.batch_spec()) == _as_tuple(jm.batch_spec())
    for bad in (dict(tp=3), dict(sp=3, tp=2)):
        with pytest.raises(ValueError, match="not divisible"):
            pm.MeshSpec.auto(8, **bad)
        with pytest.raises(ValueError, match="not divisible"):
            jm.MeshSpec.auto(8, **bad)


def test_entry_points_need_a_card_or_a_process_group():
    """Without a process group ``auto`` has no world size; ``make_mesh``
    and ``LocalRanks`` default to the card and raise without one."""
    with pytest.raises(RuntimeError, match="not initialised"):
        pm.MeshSpec.auto()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pm.make_mesh(pm.MeshSpec())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LocalRanks(2)



def _rank_plus(x):
    import torch.distributed as dist
    return dist.get_rank() + x


def _rank_one_dies():
    """Rank 1 exits; rank 0 waits for it in an all-reduce."""
    import os

    import torch.distributed as dist
    if dist.get_rank() == 1:
        os._exit(3)
    t = torch.ones(1)
    dist.all_reduce(t)
    return t.item()


def test_local_ranks_fail_fast_when_a_rank_dies():
    """A rank that dies fails the call at once with its exit code, and the
    rank left waiting in a collective is killed rather than left to hang
    until the process group's timeout."""
    with LocalRanks(2, device="cpu") as r:
        assert r.run(_rank_plus, 10) == [10, 11]
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match=r"rank 1 died \(exit code 3\)"):
            r.run(_rank_one_dies)
        assert time.monotonic() - t0 < 60
        assert not any(p.is_alive() for p in r._procs)

@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_param_specs_match_jax(moe):
    from ray_tpu.models.transformer import TransformerConfig as JCfg
    from ray_tpu.models.transformer import param_specs as jspecs
    from ray_tpu_torch.models import TransformerConfig, param_specs
    kw = dict(CFG, use_moe=moe, n_experts=4)
    assert (_flat_specs(param_specs(TransformerConfig(**kw)))
            == _flat_specs(jspecs(JCfg(**kw))))


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_state_specs_match_jax(moe):
    """Adam's mu and nu shard like their params, in the leaf order of the
    given params (here JAX's, whose dicts come back key-sorted), and every
    other leaf is replicated."""
    import jax
    import jax.numpy as jnp
    import optax
    from ray_tpu.models import TransformerConfig as JCfg
    from ray_tpu.models import init_params as jinit
    from ray_tpu.models import make_optimizer as jopt
    from ray_tpu.models.training import state_specs as jstate_specs
    from ray_tpu_torch.models import (
        TransformerConfig, make_optimizer, params_from_jax, state_specs)
    from ray_tpu_torch.models.training import param_leaves
    kw = dict(CFG, use_moe=moe, n_experts=4)
    jcfg = JCfg(**kw, dtype=jnp.float32)
    tx = jopt()
    shapes = jax.eval_shape(lambda k: jinit(k, jcfg), jax.random.PRNGKey(0))
    want = jstate_specs(jcfg, tx, shapes)
    params = params_from_jax(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes),
        device="cpu")
    got = state_specs(TransformerConfig(**kw), make_optimizer(), params)

    assert _as_tuple(got.step) == _as_tuple(want.step) == ()
    assert _flat_specs(got.params) == _flat_specs(want.params)
    adam = [n for n in jax.tree.leaves(
        want.opt_state, is_leaf=lambda n: isinstance(n, optax.ScaleByAdamState))
        if isinstance(n, optax.ScaleByAdamState)]
    assert len(adam) == 1
    assert _as_tuple(got.opt_state.count) == _as_tuple(adam[0].count) == ()
    for moments, jmoments in ((got.opt_state.mu, adam[0].mu),
                              (got.opt_state.nu, adam[0].nu)):
        jflat = _flat_specs(jmoments)
        # the port's moments follow param_leaves(params): the same paths
        paths = list(_flat_specs(pm.tree_map(lambda _, s: s, params,
                                             got.params)))
        assert len(paths) == len(param_leaves(params)) == len(moments)
        assert [_as_tuple(s) for s in moments] == [jflat[p] for p in paths]
    others = [s for s in jax.tree.leaves(
        want.opt_state, is_leaf=lambda n: isinstance(n, optax.ScaleByAdamState))
        if not isinstance(s, optax.ScaleByAdamState)]
    assert all(_as_tuple(s) == () for s in others)


# ------------------------------------------------------------ rank side

def _port_blocks(x, params, cfg_kw):
    """On each rank: its coordinate on the (fsdp 2, tp 2) mesh, its blocks
    of ``x`` under SPECS by ``shard``, by ``local_block`` and by a
    ``NamedSharding``, its blocks of the JAX parameters, and its blocks of
    the port's own mesh-sharded ``init_params`` beside the unsharded
    one's."""
    from ray_tpu_torch.models import (
        TransformerConfig, init_params, param_specs, shard_params_from_jax)
    from ray_tpu_torch.parallel.mesh import (
        MeshSpec, P, local_block, make_mesh, shard, tree_shardings)
    mesh = make_mesh(MeshSpec(fsdp=2, tp=2), device="cpu")
    xt = torch.from_numpy(x)
    shards, views = [], []
    for spec in SPECS:
        spec = P(*spec)
        d = shard(mesh, xt, spec)
        assert tuple(d.shape) == x.shape
        assert torch.equal(d.full_tensor(), xt)
        shards.append(d.to_local().numpy())
        views.append(local_block(mesh, xt, spec).numpy())
    named = tree_shardings(mesh, {"a": [P("fsdp", "tp")]})["a"][0]
    assert named.placements == tuple(
        pm.placements(mesh, P("fsdp", "tp")))
    assert named.shard_shape(x.shape) == (x.shape[0] // 2, x.shape[1] // 2)
    cfg = TransformerConfig(**cfg_kw, dtype=torch.float32)
    specs = param_specs(cfg)
    blocks = shard_params_from_jax(params, mesh, specs, device="cpu")
    mine = init_params(cfg, 3, device="cpu", mesh=mesh)
    full = init_params(cfg, 3, device="cpu")
    same = pm.tree_map(lambda a, b, s: torch.equal(a, local_block(mesh, b, s)),
                       mine, full, specs)
    return (list(mesh.get_coordinate()), shards, views,
            pm.tree_map(lambda t: t.numpy(), blocks), same)


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        return [lp for k, v in tree.items()
                for lp in _leaves_with_paths(v, path + (k,))]
    if isinstance(tree, list):
        return [lp for i, v in enumerate(tree)
                for lp in _leaves_with_paths(v, path + (i,))]
    return [(path, tree)]


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_shards_match_jax_addressable_shards(ranks, moe):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from ray_tpu.models import TransformerConfig as JCfg
    from ray_tpu.models import init_params as jinit
    from ray_tpu.models.transformer import param_specs as jspecs
    from ray_tpu.parallel import mesh as jm
    kw = dict(CFG, use_moe=moe, n_experts=4)
    jcfg = JCfg(**kw, dtype=jnp.float32)
    mesh = jm.make_mesh(jm.MeshSpec(fsdp=2, tp=2), jax.devices()[:WORLD])
    x = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    params = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jcfg))
    specs = jspecs(jcfg)

    def block(arr, spec, rank):
        a = jax.device_put(arr, NamedSharding(mesh, spec))
        return np.asarray(next(s for s in a.addressable_shards
                               if s.device.id == rank).data)

    for rank, (coord, shards, views, blocks, same) in enumerate(
            ranks.run(_port_blocks, x, params, kw)):
        where = np.argwhere(np.vectorize(lambda d: d.id)(mesh.devices)
                            == rank)
        assert coord == where[0].tolist()
        for spec, got, view in zip(SPECS, shards, views):
            want = block(x, JP(*spec), rank)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(view, want)
        for path, got in _leaves_with_paths(blocks):
            arr, spec = params, specs
            for key in path:
                arr, spec = arr[key], spec[key]
            np.testing.assert_array_equal(got, block(arr, spec, rank))
        assert all(ok for _, ok in _leaves_with_paths(same))


def _port_mesh_checks():
    """On each rank: MeshSpec.auto() from the world size, and the refusals
    of make_mesh and of specs the mesh cannot hold."""
    from ray_tpu_torch.parallel.mesh import (
        MeshSpec, P, local_mesh, make_mesh, placements, shard_shape)
    from torch.distributed.tensor import Replicate, Shard
    assert MeshSpec.auto() == MeshSpec(fsdp=WORLD)
    assert MeshSpec.auto(tp=2) == MeshSpec(fsdp=2, tp=2)
    mesh = local_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("dp", "fsdp", "pp", "sp", "tp")
    assert tuple(mesh.shape) == (1, WORLD, 1, 1, 1)
    errors = []
    for fn in (lambda: make_mesh(MeshSpec(fsdp=2), device="cpu"),
               lambda: placements(mesh, P(("fsdp", "dp"), None)),
               lambda: placements(mesh, P("fsdp", "fsdp")),
               lambda: placements(mesh, P("ep")),
               lambda: shard_shape(mesh, (6, 4), P("fsdp"))):
        try:
            fn()
        except ValueError as e:
            errors.append(str(e))
    mesh = make_mesh(MeshSpec(fsdp=2, tp=2), device="cpu")
    got = placements(mesh, P(("dp", "fsdp"), "tp"))
    assert got == (Shard(0), Shard(0), Replicate(), Replicate(), Shard(1))
    return errors


def test_mesh_from_world_size_and_refusals(ranks):
    for errors in ranks.run(_port_mesh_checks):
        assert len(errors) == 5, errors
        assert "needs 2 ranks" in errors[0]
        assert "mesh order" in errors[1]
        assert "twice" in errors[2]
        assert "not an axis" in errors[3]
        assert "not divisible" in errors[4]
