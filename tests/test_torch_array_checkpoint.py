"""The port's sharded checkpoints (``ray_tpu_torch/train/array_checkpoint``,
over ``torch.distributed.checkpoint``) against the JAX package's (orbax):
the cases of ``tests/test_array_checkpoint.py``, with the same values.

The reference's cases run on 8 devices with a mesh of fsdp 4 x tp 2; the
port's run on 4 CPU ranks of a gloo process group (``LocalRanks``, which
runs 4 on the CPU) with fsdp 2 x tp 2, and its fsdp-only async case on
fsdp 4 where the reference's has fsdp 8. The resharded restore loads on
another world size: saved by the 4 ranks, restored by 2 ranks of a new
group into ``P("tp", "fsdp")``. The JAX side runs in the pytest process
on conftest.py's CPU devices. Beyond the reference's cases: a tensor
updated in place as soon as an async save returns restores its old
values, and Python scalar leaves come back as the Python values they
were, as orbax gives them back, and an async save runs beside the
all-reduces that a training step issues on the default group.

Rank functions are module-level so that the spawned ranks import them;
JAX is imported only inside the test functions."""

import numpy as np
import pytest
import torch

from ray_tpu_torch.parallel.launch import LocalRanks

W = np.arange(64.0, dtype=np.float32).reshape(8, 8)


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
    with LocalRanks(4, device="cpu") as r:
        yield r


# -- the port's side, on each rank ------------------------------------------

def _mesh(**axes):
    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    return make_mesh(MeshSpec(**axes), device="cpu")


def _sharded_tree(mesh):
    from ray_tpu_torch.parallel.mesh import P, shard
    return {"w": shard(mesh, torch.from_numpy(W), P("fsdp", "tp")),
            "b": shard(mesh, torch.ones(8), P("tp")),
            "step": torch.tensor(7, dtype=torch.int32)}


def _seen(tree):
    """What a rank can report of a restored tree: each DTensor's whole
    value, its own block and its placements; other leaves as they are."""
    from torch.distributed.tensor import DTensor
    out = {}
    for k, v in tree.items():
        if isinstance(v, DTensor):
            out[k] = (v.full_tensor().numpy(), v.to_local().numpy(),
                      tuple(str(p) for p in v.placements))
        elif isinstance(v, torch.Tensor):
            out[k] = (v.numpy(), str(v.dtype))
        else:
            out[k] = (v, type(v).__name__)
    return out


def _port_save_restore(path):
    from ray_tpu_torch.train.array_checkpoint import (restore_sharded,
                                                      save_sharded)
    tree = _sharded_tree(_mesh(fsdp=2, tp=2))
    save_sharded(path, tree)
    restored = restore_sharded(path, tree)
    return _seen(tree), _seen(restored)


def _port_save(path):
    from ray_tpu_torch.train.array_checkpoint import save_sharded
    save_sharded(path, _sharded_tree(_mesh(fsdp=2, tp=2)))


def _port_restore_resharded(path):
    from ray_tpu_torch.parallel.mesh import NamedSharding, P
    from ray_tpu_torch.train.array_checkpoint import (ArraySpec,
                                                      restore_sharded)
    mesh2 = _mesh(fsdp=2)
    template = {
        "w": ArraySpec((8, 8), torch.float32,
                       sharding=NamedSharding(mesh2, P("tp", "fsdp"))),
        "b": ArraySpec((8,), torch.float32,
                       sharding=NamedSharding(mesh2, P(None))),
        "step": ArraySpec((), torch.int32, device="cpu"),
    }
    out = _seen(restore_sharded(path, template))
    out["want"] = tuple(str(p) for p in template["w"].sharding.placements)
    return out


def _port_async(path, touch):
    """Async save of an fsdp-4 vector; with ``touch``, the vector and a
    replicated tensor are updated in place as soon as the call returns,
    before ``wait``. Python scalars ride along."""
    from ray_tpu_torch.parallel.mesh import P, shard
    from ray_tpu_torch.train.array_checkpoint import (restore_sharded,
                                                      save_sharded)
    mesh = _mesh(fsdp=4)
    x = shard(mesh, torch.arange(32.0), P("fsdp"))
    tree = {"x": x, "m": torch.full((3,), 2.0), "n": 7, "lr": 0.5}
    handle = save_sharded(path, tree, async_save=True)
    assert handle is not None
    if touch:
        x.to_local().add_(100.0)
        tree["m"].mul_(-1.0)
    handle.wait()
    template = {"x": x, "m": torch.zeros(3), "n": 0, "lr": 0.0}
    return _seen(restore_sharded(path, template))


def _port_async_beside_training_collectives(path):
    """An async save while the main thread runs 20 all-reduces on the
    default group, as a training step does; then the restore."""
    import torch.distributed as dist

    from ray_tpu_torch.train import array_checkpoint as ac
    tree = _sharded_tree(_mesh(fsdp=2, tp=2))
    handle = ac.save_sharded(path, tree, async_save=True)
    sums = []
    for i in range(20):
        t = torch.full((1024,), float(dist.get_rank() + i))
        dist.all_reduce(t)
        sums.append(float(t[0]))
    handle.wait()
    own_group = ac._dcp_group() is not dist.group.WORLD
    return sums, own_group, _seen(tree), _seen(ac.restore_sharded(path, tree))


# -- the reference's side ----------------------------------------------------

def _jax_tree(mesh):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP
    return {"w": jax.device_put(jnp.asarray(W), NamedSharding(
                mesh, JP("fsdp", "tp"))),
            "b": jax.device_put(jnp.ones(8), NamedSharding(mesh, JP("tp"))),
            "step": jnp.int32(7)}


def test_save_restore_preserves_values_and_sharding(ranks, tmp_path):
    import jax

    from ray_tpu.parallel.mesh import MeshSpec, make_mesh
    from ray_tpu.train.array_checkpoint import restore_sharded, save_sharded
    mesh = make_mesh(MeshSpec(fsdp=4, tp=2), jax.devices()[:8])
    tree = _jax_tree(mesh)
    save_sharded(str(tmp_path / "jax"), tree)
    ref = restore_sharded(str(tmp_path / "jax"), tree)

    for rank, (saved, got) in enumerate(
            ranks.run(_port_save_restore, str(tmp_path / "port"))):
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[k][0], saved[k][0])
            np.testing.assert_array_equal(got[k][0], np.asarray(ref[k]))
            # each rank's own block and layout are the saved ones
            np.testing.assert_array_equal(got[k][1], saved[k][1])
            assert got[k][2] == saved[k][2], (rank, k)
        assert got["step"][1] == "torch.int32"
        assert int(got["step"][0]) == int(ref["step"]) == 7
    assert ref["w"].sharding == tree["w"].sharding


def test_restore_into_different_sharding(ranks, tmp_path):
    """Shards load straight into a NEW layout on another world size
    (resharding on restore — what topology changes between save and
    load require)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from ray_tpu.parallel.mesh import MeshSpec, make_mesh
    from ray_tpu.train.array_checkpoint import restore_sharded, save_sharded
    mesh = make_mesh(MeshSpec(fsdp=4, tp=2), jax.devices()[:8])
    save_sharded(str(tmp_path / "jax"), _jax_tree(mesh))
    mesh2 = make_mesh(MeshSpec(fsdp=2, tp=2), jax.devices()[:4])
    template = {
        "w": jax.ShapeDtypeStruct(
            (8, 8), jnp.float32,
            sharding=NamedSharding(mesh2, JP("tp", "fsdp"))),
        "b": jax.ShapeDtypeStruct(
            (8,), jnp.float32, sharding=NamedSharding(mesh2, JP(None))),
        "step": jax.ShapeDtypeStruct((), jnp.int32),
    }
    ref = restore_sharded(str(tmp_path / "jax"), template)
    assert ref["w"].sharding.spec == JP("tp", "fsdp")

    path = str(tmp_path / "port")
    ranks.run(_port_save, path)
    with LocalRanks(2, device="cpu") as two:
        restored = two.run(_port_restore_resharded, path)
    for rank, got in enumerate(restored):
        np.testing.assert_array_equal(got["w"][0], W)
        np.testing.assert_array_equal(got["w"][0], np.asarray(ref["w"]))
        # P("tp", "fsdp") on (fsdp 2, tp 1): this rank's columns
        np.testing.assert_array_equal(got["w"][1],
                                      W[:, rank * 4:(rank + 1) * 4])
        assert got["w"][2] == got["want"], got["w"][2]
        assert "S(1)" in got["want"]
        np.testing.assert_array_equal(got["b"][0], np.asarray(ref["b"]))
        assert int(got["step"][0]) == int(ref["step"]) == 7


def test_async_save_off_the_step_path(ranks, tmp_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from ray_tpu.parallel.mesh import MeshSpec, make_mesh
    from ray_tpu.train.array_checkpoint import restore_sharded, save_sharded
    mesh = make_mesh(MeshSpec(fsdp=8), jax.devices()[:8])
    x = jax.device_put(jnp.arange(32.0), NamedSharding(mesh, JP("fsdp")))
    handle = save_sharded(str(tmp_path / "jax"), {"x": x}, async_save=True)
    assert handle is not None
    handle.wait()
    ref = restore_sharded(str(tmp_path / "jax"), {"x": x})
    np.testing.assert_array_equal(np.asarray(ref["x"]), np.arange(32.0))

    for got in ranks.run(_port_async, str(tmp_path / "port"), False):
        np.testing.assert_array_equal(got["x"][0], np.asarray(ref["x"]))


def test_async_save_stages_before_it_returns(ranks, tmp_path):
    """The reference's contract: training may overwrite the arrays while
    the bytes stream out. The port's AdamW updates in place, so an async
    save must have copied the tensors before it returns: the tensors are
    changed in place right after the call, and the restore gives the
    values they had at the call."""
    for got in ranks.run(_port_async, str(tmp_path / "port"), True):
        np.testing.assert_array_equal(got["x"][0], np.arange(32.0))
        np.testing.assert_array_equal(got["m"][0], np.full(3, 2.0))


def test_python_scalar_leaves_round_trip_like_the_reference(ranks,
                                                             tmp_path):
    """A Python int or float leaf comes back as the same Python value in
    both packages (orbax and DCP both store it as an object)."""
    import jax.numpy as jnp

    from ray_tpu.train.array_checkpoint import restore_sharded, save_sharded
    tree = {"x": jnp.arange(4.0), "n": 7, "lr": 0.5}
    save_sharded(str(tmp_path / "jax"), tree)
    ref = restore_sharded(str(tmp_path / "jax"), tree)
    assert (type(ref["n"]), type(ref["lr"])) == (int, float)
    for got in ranks.run(_port_async, str(tmp_path / "port"), False):
        assert got["n"] == (ref["n"], "int")
        assert got["lr"] == (ref["lr"], "float")


def test_async_save_beside_training_collectives(ranks, tmp_path):
    """The background write's collectives run on a group of their own, so
    the collectives a training step issues on the default group while
    the bytes stream out neither hang nor mix with them: every
    all-reduce gives its sum, and the restore gives the saved tree."""
    for sums, own_group, saved, got in ranks.run(
            _port_async_beside_training_collectives, str(tmp_path / "port")):
        assert own_group
        assert sums == [float(6 + 4 * i) for i in range(20)]
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[k][0], saved[k][0])
            np.testing.assert_array_equal(got[k][1], saved[k][1])
        assert int(got["step"][0]) == 7
