"""The port's placement groups: the cases of
``tests/test_placement_group.py`` on ``ray_tpu_torch`` (gang
reservation, strategies, bundle-scoped tasks and actors, removal,
captured child tasks, infeasible demands, bundle index checks, groups
dissolved when a node dies), on a CPU-only head with logical nodes.
"""

import time

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    _PgCaptureContext,
    placement_group,
    placement_group_table,
    remove_placement_group,
)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def ray_start_cluster():
    """The reference's fixture on the port: a CPU-only head (no card
    here) plus a helper for adding nodes."""
    from ray_tpu_torch.cluster_utils import Cluster
    cluster = Cluster(num_gpus=0, head_num_cpus=4)
    yield cluster
    cluster.shutdown()


def test_pg_create_ready_and_reserve(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=4)
    pg = placement_group([{"CPU": 2}, {"CPU": 2}], strategy="PACK")
    assert pg.wait(10)
    got = ray_tpu_torch.get(pg.ready(), timeout=10)
    assert isinstance(got, PlacementGroup)
    assert got.id == pg.id
    # reservation shows up as consumed capacity
    avail = ray_tpu_torch.available_resources()
    total = ray_tpu_torch.cluster_resources()
    assert total["CPU"] - avail["CPU"] >= 4


def test_pg_task_runs_in_bundle(ray_start_cluster):
    cluster = ray_start_cluster
    nid = cluster.add_node(num_cpus=8, resources={"special": 2})
    pg = placement_group([{"CPU": 2, "special": 1}], strategy="PACK")
    assert pg.wait(10)
    info = cluster.worker.pg_manager.get(pg.id)
    assert info.bundle_nodes == [nid]

    @ray_tpu_torch.remote
    def where():
        return "ran"

    from ray_tpu_torch.util.scheduling_strategies import (
        PlacementGroupSchedulingStrategy)
    ref = where.options(
        num_cpus=1,
        scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=0)).remote()
    assert ray_tpu_torch.get(ref, timeout=30) == "ran"
    # bundle capacity returned after the task
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if info.bundle_avail[0].get("CPU") == 2:
            break
        time.sleep(0.01)
    assert info.bundle_avail[0].get("CPU") == 2


def test_pg_strict_spread_needs_nodes(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=4)
    # head + 1 node; 3 bundles strict-spread can't fit on 2 nodes
    pg = placement_group([{"CPU": 1}] * 3, strategy="STRICT_SPREAD")
    assert not pg.wait(0.5)
    cluster.add_node(num_cpus=4)
    assert pg.wait(10)
    info = cluster.worker.pg_manager.get(pg.id)
    assert len(set(info.bundle_nodes)) == 3


def test_pg_strict_pack_one_node(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=16)
    pg = placement_group([{"CPU": 4}, {"CPU": 4}], strategy="STRICT_PACK")
    assert pg.wait(10)
    info = cluster.worker.pg_manager.get(pg.id)
    assert len(set(info.bundle_nodes)) == 1


def test_pg_remove_frees_resources(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=4)
    before = ray_tpu_torch.available_resources()["CPU"]
    pg = placement_group([{"CPU": 4}], strategy="PACK")
    assert pg.wait(10)
    assert ray_tpu_torch.available_resources()["CPU"] == before - 4
    remove_placement_group(pg)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if ray_tpu_torch.available_resources()["CPU"] == before:
            break
        time.sleep(0.01)
    assert ray_tpu_torch.available_resources()["CPU"] == before
    table = placement_group_table()
    entry = [e for e in table if e["placement_group_id"] == pg.id.hex()][0]
    assert entry["state"] == "REMOVED"


def test_pg_task_after_remove_fails(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=4)
    pg = placement_group([{"CPU": 2}], strategy="PACK")
    assert pg.wait(10)
    remove_placement_group(pg)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not any(
            e["placement_group_id"] == pg.id.hex() and e["state"] == "REMOVED"
            for e in placement_group_table()):
        time.sleep(0.01)

    @ray_tpu_torch.remote
    def f():
        return 1

    from ray_tpu_torch.util.scheduling_strategies import (
        PlacementGroupSchedulingStrategy)
    ref = f.options(
        num_cpus=1,
        scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=pg)).remote()
    with pytest.raises(ray_tpu_torch.exceptions.PlacementGroupError):
        ray_tpu_torch.get(ref, timeout=10)


def test_pg_actor_in_bundle_and_release(ray_start_cluster):
    cluster = ray_start_cluster
    nid = cluster.add_node(num_cpus=4, resources={"special": 1})
    pg = placement_group([{"CPU": 2, "special": 1}], strategy="PACK")
    assert pg.wait(10)

    @ray_tpu_torch.remote
    class A:
        def node(self):
            return "alive"

    a = A.options(
        num_cpus=2, placement_group=pg,
        placement_group_bundle_index=0).remote()
    assert ray_tpu_torch.get(a.node.remote(), timeout=30) == "alive"
    info = cluster.worker.pg_manager.get(pg.id)
    assert info.bundle_nodes == [nid]
    assert info.bundle_avail[0].get("CPU") == 0
    ray_tpu_torch.kill(a)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if info.bundle_avail[0].get("CPU") == 2:
            break
        time.sleep(0.01)
    assert info.bundle_avail[0].get("CPU") == 2


def test_pg_capture_child_tasks(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=4)
    pg = placement_group([{"CPU": 2}], strategy="PACK",
                         _capture_child_tasks=True)
    assert pg.wait(10)

    @ray_tpu_torch.remote
    def f():
        return 7

    with _PgCaptureContext(pg):
        ref = f.options(num_cpus=1).remote()
    assert ray_tpu_torch.get(ref, timeout=30) == 7


def test_pg_infeasible_bundle_demand(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=2)
    pg = placement_group([{"CPU": 2}], strategy="PACK")
    assert pg.wait(10)

    @ray_tpu_torch.remote
    def f():
        return 1

    from ray_tpu_torch.util.scheduling_strategies import (
        PlacementGroupSchedulingStrategy)
    # demand exceeds the whole bundle -> immediate failure, not a hang
    ref = f.options(
        num_cpus=4,
        scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=pg)).remote()
    with pytest.raises(ray_tpu_torch.exceptions.PlacementGroupError):
        ray_tpu_torch.get(ref, timeout=10)


def test_pg_actor_infeasible_demand_fails_fast(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=4)
    pg = placement_group([{"CPU": 2}], strategy="PACK")
    assert pg.wait(10)

    @ray_tpu_torch.remote
    class A:
        def ping(self):
            return 1

    # actor demand exceeds the bundle: creation must fail, and calls
    # must error instead of hanging
    a = A.options(num_cpus=4, placement_group=pg).remote()
    with pytest.raises(ray_tpu_torch.exceptions.RayTpuError):
        ray_tpu_torch.get(a.ping.remote(), timeout=10)


def test_pg_out_of_range_bundle_index(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=4)
    pg = placement_group([{"CPU": 2}], strategy="PACK")
    assert pg.wait(10)

    @ray_tpu_torch.remote
    def f():
        return 1

    from ray_tpu_torch.util.scheduling_strategies import (
        PlacementGroupSchedulingStrategy)
    ref = f.options(
        num_cpus=1,
        scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=5)).remote()
    with pytest.raises(ray_tpu_torch.exceptions.PlacementGroupError):
        ray_tpu_torch.get(ref, timeout=10)
    # unrelated tasks in the same scheduling batch still run
    assert ray_tpu_torch.get(f.options(num_cpus=1).remote(), timeout=30) == 1


def test_pg_ready_after_remove_raises(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=4)
    pg = placement_group([{"CPU": 2}], strategy="PACK")
    assert pg.wait(10)
    remove_placement_group(pg)
    with pytest.raises(ray_tpu_torch.exceptions.PlacementGroupError):
        ray_tpu_torch.get(pg.ready(), timeout=10)


def test_pg_dissolved_on_node_death(ray_start_cluster):
    cluster = ray_start_cluster
    nid = cluster.add_node(num_cpus=4, resources={"special": 1})
    pg = placement_group([{"CPU": 2, "special": 1}], strategy="PACK")
    assert pg.wait(10)
    info = cluster.worker.pg_manager.get(pg.id)
    assert info.bundle_nodes == [nid]
    cluster.remove_node(nid)
    assert info.state == "REMOVED"

    @ray_tpu_torch.remote
    def f():
        return 1

    from ray_tpu_torch.util.scheduling_strategies import (
        PlacementGroupSchedulingStrategy)
    ref = f.options(
        num_cpus=1,
        scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=pg)).remote()
    with pytest.raises(ray_tpu_torch.exceptions.PlacementGroupError):
        ray_tpu_torch.get(ref, timeout=10)
