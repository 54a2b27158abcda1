"""The port's slice meshes (ray_tpu_torch.parallel.slice_mesh) against the
cases of tests/test_slice_mesh.py, on rank descriptors.

Each case of the JAX package's file up to its train step has its
counterpart here, with the same inputs and the same error messages: its
``_FakeDev`` becomes the port's ``RankDevice`` (a CUDA rank unless the
case says ``platform="cpu"``), and its virtual CPU devices become CPU rank
descriptors. The geometry needs no process group. The broadcast, the
slice's own mesh and the train step run on 4 spawned gloo ranks
(``LocalRanks``): the step on a slice mesh of 2 slices x fsdp 2 (dp across
slices) against the same layout built as one flat (dp 2, fsdp 2) mesh,
losses to 1e-5 relative, the bound of tests/test_slice_mesh.py:199.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.parallel.launch import LocalRanks
from ray_tpu_torch.parallel.mesh import MeshSpec
from ray_tpu_torch.parallel.slice_mesh import (
    RankDevice, SliceTopology, group_devices_by_slice, make_slice_mesh)

WORLD = 4


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


def _cpu_ranks(n):
    """The counterpart of ``jax.devices()`` on the virtual CPU platform:
    one host, no slice ids."""
    return [RankDevice(i, platform="cpu") for i in range(n)]


def test_topology_validation():
    with pytest.raises(ValueError, match="cross axis"):
        SliceTopology(num_slices=2, inner=MeshSpec(fsdp=4), cross="qp")
    with pytest.raises(ValueError, match="leave the cross axis"):
        SliceTopology(num_slices=2, inner=MeshSpec(dp=2, fsdp=2), cross="dp")
    with pytest.raises(ValueError, match="num_slices"):
        SliceTopology(num_slices=0, inner=MeshSpec(fsdp=4))


def test_grouping_positional_single_process():
    devs = _cpu_ranks(8)
    groups = group_devices_by_slice(devs, 2)
    assert [len(g) for g in groups] == [4, 4]
    assert groups[0] == devs[:4] and groups[1] == devs[4:]
    with pytest.raises(ValueError, match="not divisible"):
        group_devices_by_slice(devs[:6], 4)


def test_grouping_hardware_slice_ids_with_surplus():
    # 2 hardware slices x 4 ranks; the topology wants 2 slices x 2: the
    # selection takes per-slice prefixes, not the positional prefix (which
    # would land entirely in slice 0).
    devs = ([RankDevice(i, slice_index=0) for i in range(4)]
            + [RankDevice(4 + i, process_index=1, slice_index=1)
               for i in range(4)])
    groups = group_devices_by_slice(devs, 2, per=2)
    assert [d.id for d in groups[0]] == [0, 1]
    assert [d.id for d in groups[1]] == [4, 5]
    with pytest.raises(ValueError, match="topology needs 5 per slice"):
        group_devices_by_slice(devs, 2, per=5)
    with pytest.raises(ValueError, match="hardware reports 2 slice"):
        group_devices_by_slice(devs, 4, per=2)


def test_single_hardware_slice_refuses_split():
    # All ranks on ONE island: splitting it would put the cross axis on the
    # island's own links; it raises unless explicitly simulating.
    devs = [RankDevice(i, slice_index=0) for i in range(8)]
    with pytest.raises(ValueError, match="allow_split_slices"):
        group_devices_by_slice(devs, 2)
    groups = group_devices_by_slice(devs, 2, allow_split_slices=True)
    assert [len(g) for g in groups] == [4, 4]


def test_grouping_processes_with_surplus_devices():
    devs = [RankDevice(i, process_index=i // 4) for i in range(8)]
    groups = group_devices_by_slice(devs, 2, per=2)
    assert [{d.process_index for d in g} for g in groups] == [{0}, {1}]
    assert [d.id for d in groups[1]] == [4, 5]


def test_grouping_processes_as_slices():
    devs = [RankDevice(i, process_index=i // 4) for i in range(8)]
    groups = group_devices_by_slice(devs, 2)
    assert [{d.process_index for d in g} for g in groups] == [{0}, {1}]
    groups4 = group_devices_by_slice(devs, 4)
    assert all(len({d.process_index for d in g}) == 1 for g in groups4)


def test_grouping_rejects_slice_straddling_processes():
    devs = [RankDevice(i, process_index=i // 4) for i in range(12)]
    with pytest.raises(ValueError, match="straddling a process boundary"):
        group_devices_by_slice(devs, 2)


def test_discovery_fallback_order():
    """slice_index beats process_index beats positional blocks: on the same
    population, stripping one signal at a time lands on the next tier, and
    the not-divisible error fires in every tier."""
    devs1 = [RankDevice(i, process_index=i % 2, slice_index=i // 4)
             for i in range(8)]
    groups = group_devices_by_slice(devs1, 2)
    assert [{d.slice_index for d in g} for g in groups] == [{0}, {1}]

    # One rank without a slice id disables the hardware tier.
    devs2 = [RankDevice(i, process_index=i // 4, slice_index=0)
             for i in range(8)]
    devs2[0] = dataclasses.replace(devs2[0], slice_index=None)
    groups = group_devices_by_slice(devs2, 2)
    assert [{d.process_index for d in g} for g in groups] == [{0}, {1}]

    devs3 = [RankDevice(i) for i in range(8)]
    groups = group_devices_by_slice(devs3, 2)
    assert [d.id for d in groups[0]] == [0, 1, 2, 3]
    assert [d.id for d in groups[1]] == [4, 5, 6, 7]

    with pytest.raises(ValueError, match="not divisible"):
        group_devices_by_slice([RankDevice(i) for i in range(7)], 2)
    with pytest.raises(ValueError, match="not divisible"):
        group_devices_by_slice(
            [RankDevice(i, process_index=i // 5) for i in range(10)], 3)


def test_slice_mesh_geometry():
    topo = SliceTopology(num_slices=2, inner=MeshSpec(fsdp=2, tp=2),
                         cross="dp")
    smesh = make_slice_mesh(topo, _cpu_ranks(8))
    assert smesh.num_slices == 2
    assert smesh.dcn_axis == "dp"
    assert dict(smesh.shape) == {"dp": 2, "fsdp": 2, "pp": 1, "sp": 1,
                                 "tp": 2}
    assert smesh.devices.shape == (2, 2, 1, 1, 2)
    # each dp row is exactly one slice's ranks
    grid = smesh.devices
    for s in range(2):
        assert set(grid[s].flatten()) == set(smesh.slice_devices(s))
    d = smesh.describe()
    assert d["slices"] == 2 and d["dcn_axis"] == "dp"
    assert d["global"]["dp"] == 2


def test_cross_axis_other_than_dp():
    topo = SliceTopology(num_slices=4, inner=MeshSpec(tp=2), cross="fsdp")
    smesh = make_slice_mesh(topo, _cpu_ranks(8))
    assert dict(smesh.shape)["fsdp"] == 4
    assert smesh.ici_axes == ("dp", "pp", "sp", "tp")
    grid = smesh.devices  # (dp, fsdp, pp, sp, tp)
    for s in range(4):
        assert set(grid[:, s].flatten()) == set(smesh.slice_devices(s))


# ------------------------------------------------------------ on ranks

def _rank_broadcast_and_submesh():
    """On each rank: 2 slices x tp 2 over the 4 CPU ranks; slice 1's tree
    broadcast to every slice, slice 1's own mesh, this rank's slice."""
    from ray_tpu_torch.parallel.slice_mesh import broadcast_one_slice_to_all
    topo = SliceTopology(num_slices=2, inner=MeshSpec(tp=2), cross="dp")
    smesh = make_slice_mesh(topo)
    mine = smesh.local_slice_index()
    tree = {"w": np.arange(12.0).reshape(3, 4),
            "b": np.asarray([7.0, -1.0])}
    if mine != 1:   # only the source slice's data may reach anyone
        tree = {k: np.full_like(v, np.nan) for k, v in tree.items()}
    out = broadcast_one_slice_to_all(tree, 1, smesh)
    try:
        broadcast_one_slice_to_all(tree, 5, smesh)
        refused = None
    except ValueError as e:
        refused = str(e)
    sub = smesh.slice_submesh(1)
    return ({k: v.numpy() for k, v in out.items()}, refused, mine,
            sub.mesh.tolist(), sub.mesh_dim_names,
            [d.platform for d in smesh.slice_devices(0)])


def test_broadcast_one_slice_to_all_and_submesh(ranks):
    results = ranks.run(_rank_broadcast_and_submesh)
    want = {"w": np.arange(12.0).reshape(3, 4), "b": np.asarray([7.0, -1.0])}
    for rank, (out, refused, mine, sub, names, platforms) in enumerate(
            results):
        for key in want:
            np.testing.assert_array_equal(out[key], want[key])
        assert "source_slice" in refused
        assert mine == rank // 2
        assert np.asarray(sub).flatten().tolist() == [2, 3]
        assert np.asarray(sub).shape == (1, 1, 1, 1, 2)
        assert names == ("dp", "fsdp", "pp", "sp", "tp")
        assert platforms == ["cpu", "cpu"]


def _rank_slice_vs_flat(tokens):
    """On each rank: two steps on the slice mesh (2 slices x fsdp 2, dp
    across slices) and two on the flat (dp 2, fsdp 2) mesh."""
    from ray_tpu_torch.models import (
        TransformerConfig, init_state, make_optimizer, make_train_step)
    from ray_tpu_torch.parallel.mesh import make_mesh
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=1,
                            n_heads=2, n_kv_heads=2, d_ff=64, max_seq_len=32,
                            dtype=torch.float32)
    tx = make_optimizer(total_steps=3)

    def run(mesh):
        state = init_state(cfg, tx, seed=0, device="cpu", mesh=mesh)
        step = make_train_step(cfg, tx, mesh)
        losses = []
        for _ in range(2):
            state, metrics = step(state, {"tokens": torch.from_numpy(tokens)})
            losses.append(metrics["loss"].item())
        return losses

    topo = SliceTopology(num_slices=2, inner=MeshSpec(fsdp=2), cross="dp")
    smesh = make_slice_mesh(topo)
    return (run(smesh.mesh), run(make_mesh(MeshSpec(dp=2, fsdp=2),
                                           device="cpu")),
            smesh.describe())


def test_train_step_slice_mesh_matches_flat_mesh(ranks):
    tokens = np.random.RandomState(0).randint(0, 64, (8, 16)).astype(
        np.int32)
    results = ranks.run(_rank_slice_vs_flat, tokens)
    for slice_losses, flat_losses, desc in results:
        assert all(np.isfinite(x) for x in slice_losses)
        np.testing.assert_allclose(slice_losses, flat_losses, rtol=1e-5)
        assert slice_losses == results[0][0]
        assert desc["slices"] == 2 and desc["global"]["dp"] == 2
