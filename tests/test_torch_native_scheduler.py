"""The port's native CPU scheduling policy
(``ray_tpu_torch/_private/scheduler/native_policy.py`` over its own copy
of ``native/scheduler.cc``, built with ``g++`` into
``ray_tpu_torch/_build/``): the parity cases of the JAX package's
``test_native_scheduler.py``, the class-fill entry point, and the port's
policy against the JAX package's on twin clusters, node for node."""

import ctypes as ct
from collections import Counter

import numpy as np
import pytest
import torch

from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.scheduler import policy as port_policy
from ray_tpu_torch._private.scheduler.policy import (
    HybridSchedulingPolicy,
    SchedulingRequest,
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


def _cluster(n=6, cpus=8.0, seed=None):
    c = ClusterResourceManager()
    ids = []
    rng = np.random.RandomState(seed) if seed is not None else None
    for i in range(n):
        nid = (NodeID(rng.bytes(NodeID.SIZE)) if rng is not None
               else NodeID.from_random())
        ids.append(nid)
        c.add_or_update_node(nid, NodeResources.of(CPU=cpus, memory=64))
    return c, ids


def _native():
    from ray_tpu_torch._private.scheduler.native_policy import (
        NativeHybridSchedulingPolicy)
    return NativeHybridSchedulingPolicy()


def test_native_builds_and_schedules():
    pol = _native()
    cluster, ids = _cluster()
    reqs = [SchedulingRequest(demand={"CPU": 1.0}) for _ in range(20)]
    results = pol.schedule_batch(cluster, reqs)
    assert all(r.node_id is not None for r in results)
    counts = Counter(r.node_id for r in results)
    assert all(v <= 8 for v in counts.values())


def test_native_prefers_local_until_threshold():
    pol = _native()
    cluster, ids = _cluster(n=3, cpus=10.0)
    pref = ids[0]
    reqs = [SchedulingRequest(demand={"CPU": 1.0}, preferred_node=pref)
            for _ in range(10)]
    results = pol.schedule_batch(cluster, reqs)
    # threshold 0.5 -> first 5 land on the preferred node
    assert [r.node_id for r in results[:5]] == [pref] * 5
    assert all(r.node_id != pref for r in results[5:8])


def test_native_infeasible_vs_busy():
    pol = _native()
    cluster, ids = _cluster(n=2, cpus=2.0)
    res = pol.schedule_batch(cluster, [
        SchedulingRequest(demand={"CPU": 100.0})])[0]
    assert res.node_id is None and res.is_infeasible
    res = pol.schedule_batch(cluster, [
        SchedulingRequest(demand={"GPU": 1.0})])[0]
    assert res.node_id is None and res.is_infeasible
    busy = pol.schedule_batch(cluster, [
        SchedulingRequest(demand={"CPU": 2.0}),
        SchedulingRequest(demand={"CPU": 2.0}),
        SchedulingRequest(demand={"CPU": 2.0})])
    assert busy[0].node_id is not None and busy[1].node_id is not None
    assert busy[2].node_id is None and not busy[2].is_infeasible


def test_native_matches_python_on_random_workload():
    pol_n = _native()
    cluster, ids = _cluster(n=8, cpus=16.0)
    rng = np.random.RandomState(0)
    reqs = [SchedulingRequest(demand={"CPU": float(rng.randint(1, 4))})
            for _ in range(64)]
    res_n = pol_n.schedule_batch(cluster, reqs)
    pol_p = HybridSchedulingPolicy(seed=0)
    res_p = pol_p.schedule_batch(cluster, reqs)
    # policies are randomized in tie-break; compare scheduled counts and
    # total allocation feasibility instead of exact node identity
    assert sum(r.node_id is not None for r in res_n) == \
        sum(r.node_id is not None for r in res_p)
    counts = Counter()
    for req, r in zip(reqs, res_n):
        if r.node_id is not None:
            counts[r.node_id] += req.demand["CPU"]
    assert all(v <= 16.0 for v in counts.values())


def test_native_class_fill_entry_point():
    from ray_tpu_torch._private.native_loader import scheduler_lib
    lib = scheduler_lib()
    assert lib is not None
    n_nodes, n_res, n_classes = 16, 2, 3
    avail = np.full((n_nodes, n_res), 8.0, np.float32)
    total = avail.copy()
    alive = np.ones(n_nodes, np.uint8)
    demands = np.asarray([[1.0, 0.0], [2.0, 1.0], [0.5, 0.0]], np.float32)
    counts = np.asarray([40, 10, 60], np.int32)
    preferred = np.full(n_classes, -1, np.int32)
    takes = np.zeros((n_classes, n_nodes), np.int32)
    f32p, u8p, i32p = (ct.POINTER(ct.c_float), ct.POINTER(ct.c_uint8),
                       ct.POINTER(ct.c_int32))
    lib.rtpu_hybrid_schedule_classes(
        avail.ctypes.data_as(f32p), total.ctypes.data_as(f32p),
        alive.ctypes.data_as(u8p), n_nodes, n_res,
        demands.ctypes.data_as(f32p), counts.ctypes.data_as(i32p),
        preferred.ctypes.data_as(i32p), n_classes, ct.c_float(0.5),
        takes.ctypes.data_as(i32p))
    assert takes.sum(axis=1).tolist() == [40, 10, 60]
    used = (takes[:, :, None] * demands[:, None, :]).sum(axis=0)
    assert (used <= total + 1e-5).all()


def test_cpu_hybrid_is_the_native_policy():
    """On the CPU the default policy's inner scan is ``hybrid_native``,
    as the reference's is when its library builds."""
    pol = port_policy.default_policy(device="cpu")
    assert pol._inner.name == "hybrid_native"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_matches_the_jax_packages_native_policy(seed):
    """The same C++ on twin clusters (the same node ids, resources and
    requests) places every request on the same node in both packages."""
    from ray_tpu._private.ids import NodeID as RNodeID
    from ray_tpu._private.scheduler.native_policy import (
        NativeHybridSchedulingPolicy as RNative)
    from ray_tpu._private.scheduler.policy import (
        SchedulingRequest as RRequest)
    from ray_tpu._private.scheduler.resources import (
        ClusterResourceManager as RCluster, NodeResources as RNodeResources)

    rng = np.random.RandomState(seed)
    n = 12
    raw = [rng.bytes(NodeID.SIZE) for _ in range(n)]
    cpus = rng.randint(2, 17, size=n).astype(float)
    mem = rng.randint(8, 65, size=n).astype(float)
    demands = [{"CPU": float(rng.randint(1, 4)),
                "memory": float(rng.randint(0, 4))} for _ in range(96)]
    prefs = rng.randint(-1, n, size=len(demands))

    port_cluster, ref_cluster = ClusterResourceManager(), RCluster()
    for b, c, m in zip(raw, cpus, mem):
        port_cluster.add_or_update_node(NodeID(b),
                                        NodeResources.of(CPU=c, memory=m))
        ref_cluster.add_or_update_node(RNodeID(b),
                                       RNodeResources.of(CPU=c, memory=m))
    port_reqs = [SchedulingRequest(
        demand=d, preferred_node=NodeID(raw[p]) if p >= 0 else None)
        for d, p in zip(demands, prefs)]
    ref_reqs = [RRequest(
        demand=d, preferred_node=RNodeID(raw[p]) if p >= 0 else None)
        for d, p in zip(demands, prefs)]
    got = _native().schedule_batch(port_cluster, port_reqs)
    want = RNative().schedule_batch(ref_cluster, ref_reqs)
    assert [r.node_id.hex() if r.node_id else None for r in got] == \
        [r.node_id.hex() if r.node_id else None for r in want]
    assert [r.is_infeasible for r in got] == [r.is_infeasible for r in want]
    assert sum(r.node_id is not None for r in got) > 0
