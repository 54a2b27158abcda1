"""The port's scheduling policies and multi-node placement: the cases of
``tests/test_scheduling.py`` on ``ray_tpu_torch`` (the hybrid policy's
local preference, spread threshold and feasibility, the spread and
random policies, GPU routing, and placement on logical nodes: custom
resources, an infeasible task made feasible by a new node, a task on a
removed node failing).
"""

import time

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.scheduler.policy import (
    HybridSchedulingPolicy,
    RandomSchedulingPolicy,
    SchedulingRequest,
    SpreadSchedulingPolicy,
)
from ray_tpu_torch._private.scheduler.resources import (
    ClusterResourceManager,
    NodeResources,
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


def _wait_for(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


def make_cluster(specs):
    mgr = ClusterResourceManager()
    ids = []
    for total in specs:
        nid = NodeID.from_random()
        mgr.add_or_update_node(nid, NodeResources.of(**total))
        ids.append(nid)
    return mgr, ids


class TestHybridPolicy:
    def test_prefers_local_below_threshold(self):
        mgr, ids = make_cluster([{"CPU": 8}, {"CPU": 8}])
        pol = HybridSchedulingPolicy(spread_threshold=0.5)
        res = pol.schedule(mgr, SchedulingRequest({"CPU": 1},
                                                  preferred_node=ids[0]))
        assert res.node_id == ids[0]

    def test_spreads_above_threshold(self):
        mgr, ids = make_cluster([{"CPU": 8}, {"CPU": 8}])
        # local node 60% utilized -> above 0.5 threshold
        mgr.allocate(ids[0], {"CPU": 5})
        pol = HybridSchedulingPolicy(spread_threshold=0.5, seed=0)
        res = pol.schedule(mgr, SchedulingRequest({"CPU": 1},
                                                  preferred_node=ids[0]))
        assert res.node_id == ids[1]

    def test_infeasible(self):
        mgr, ids = make_cluster([{"CPU": 2}])
        pol = HybridSchedulingPolicy()
        res = pol.schedule(mgr, SchedulingRequest({"GPU": 1}))
        assert res.node_id is None
        assert res.is_infeasible

    def test_unavailable_not_infeasible(self):
        mgr, ids = make_cluster([{"CPU": 2}])
        mgr.allocate(ids[0], {"CPU": 2})
        pol = HybridSchedulingPolicy()
        res = pol.schedule(mgr, SchedulingRequest({"CPU": 1}))
        assert res.node_id is None
        assert not res.is_infeasible

    def test_batch_spreads_load(self):
        mgr, ids = make_cluster([{"CPU": 2}, {"CPU": 2}, {"CPU": 2}])
        pol = HybridSchedulingPolicy(spread_threshold=0.5, seed=1)
        reqs = [SchedulingRequest({"CPU": 1}, preferred_node=ids[0])
                for _ in range(6)]
        results = pol.schedule_batch(mgr, reqs)
        chosen = [r.node_id for r in results]
        assert all(c is not None for c in chosen)
        # 6 one-cpu tasks over 3 two-cpu nodes must use all nodes
        assert len(set(chosen)) == 3

    def test_custom_resources(self):
        mgr, ids = make_cluster([{"CPU": 4}, {"CPU": 4, "accel": 2}])
        pol = HybridSchedulingPolicy()
        res = pol.schedule(mgr, SchedulingRequest({"accel": 1}))
        assert res.node_id == ids[1]


class TestOtherPolicies:
    def test_spread_round_robin(self):
        mgr, ids = make_cluster([{"CPU": 4}] * 4)
        pol = SpreadSchedulingPolicy()
        reqs = [SchedulingRequest({"CPU": 1}) for _ in range(4)]
        chosen = {r.node_id for r in pol.schedule_batch(mgr, reqs)}
        assert len(chosen) == 4

    def test_random_feasibility(self):
        mgr, ids = make_cluster([{"CPU": 1}, {"GPU": 1, "CPU": 1}])
        pol = RandomSchedulingPolicy(seed=0)
        for _ in range(5):
            res = pol.schedule(mgr.__class__() if False else mgr,
                               SchedulingRequest({"GPU": 1}))
            assert res.node_id == ids[1]
            mgr.free(ids[1], {"GPU": 1})


class TestClusterPlacement:
    def test_custom_resource_routes_to_node(self, ray_start_cluster):
        cluster = ray_start_cluster
        cluster.add_node(num_cpus=2, resources={"special": 1})

        @ray_tpu_torch.remote(num_cpus=1, resources={"special": 1})
        def where():
            import os
            return os.getpid()

        # must run (only the added node has "special")
        assert isinstance(ray_tpu_torch.get(where.remote()), int)

    def test_infeasible_becomes_feasible(self, ray_start_cluster):
        cluster = ray_start_cluster

        @ray_tpu_torch.remote(resources={"late": 1})
        def waits():
            return "ran"

        ref = waits.remote()
        _wait_for(lambda: cluster.worker.node_group.stats()["infeasible"],
                  what="the task to be found infeasible")
        cluster.add_node(num_cpus=2, resources={"late": 1})
        assert ray_tpu_torch.get(ref, timeout=60) == "ran"

    def test_node_death_task_retry(self, ray_start_cluster):
        cluster = ray_start_cluster
        nid = cluster.add_node(num_cpus=2, resources={"doomed": 1})

        @ray_tpu_torch.remote(resources={"doomed": 1}, max_retries=0)
        def trapped():
            import time
            time.sleep(60)

        ref = trapped.remote()
        _wait_for(lambda: cluster.worker.node_group.stats()["running"],
                  what="the task to start")
        cluster.remove_node(nid)
        with pytest.raises(Exception):
            ray_tpu_torch.get(ref, timeout=30)
