"""The port's multi-node plane against the reference and its own rules:
one scenario run under both packages' ``Cluster`` in turn (a head and two
remote raylets; a 16 MB array made on node 1 and summed on node 2; 40
tasks under the spread policy) with equal results, placements and pulled
bytes; a remote node with GPUs refused; and a torch tensor held in the
head's device tier read by a task on a remote raylet.
"""

import collections
import os
import time

import numpy as np
import pytest
import torch

ARRAY_ELEMS = 2 * 1024 * 1024     # int64: 16 MB
N_SPREAD = 40


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


class _Spread:
    """The spread policy's strategy: both packages' composite policy
    routes ``kind == "SPREAD"`` to round robin over the feasible nodes
    (neither has a public class for it)."""

    kind = "SPREAD"


def _wait_for(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while True:
        value = cond()
        if value:
            return value
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


def _make(n):
    return np.arange(n, dtype=np.int64) * 3


def _total(a):
    return int(a.sum()), os.getppid()


def _spread_task(i):
    return i * i, os.getppid()


def _scenario(pkg, Cluster, affinity, **no_accelerator):
    """Run the scenario on ``pkg``; returns its results, the placements
    by node role and the bytes each remote raylet pulled."""
    cluster = Cluster(head_num_cpus=2, start_gcs=True, **no_accelerator)
    try:
        w = cluster.worker
        nodes = {"n1": cluster.add_node(num_cpus=2, remote=True,
                                        resources={"S": 100}),
                 "n2": cluster.add_node(num_cpus=2, remote=True,
                                        resources={"S": 100})}
        role = {w.node_group._remote_nodes[nid].proc.pid: name
                for name, nid in nodes.items()}
        role[os.getpid()] = "head"

        def on(name):
            return affinity(nodes[name].hex(), soft=False)

        make = pkg.remote(_make)
        total = pkg.remote(_total)
        ref = make.options(scheduling_strategy=on("n1")).remote(ARRAY_ELEMS)
        summed, ppid = pkg.get(
            total.options(scheduling_strategy=on("n2")).remote(ref),
            timeout=120)
        spread = pkg.remote(num_cpus=0, resources={"S": 1})(_spread_task)
        out = pkg.get([spread.options(scheduling_strategy=_Spread())
                       .remote(i) for i in range(N_SPREAD)], timeout=120)
        placements = collections.Counter(role.get(p, p) for _, p in out)

        def pulled(name):
            stats = w.node_group._remote_nodes[nodes[name]].client.call(
                "stats")
            return stats["num_pulled"]

        def pulled_bytes(name):
            report = w.node_stats.get(nodes[name])
            if report is None:
                return 0
            return report[1]["wire"].get("object_transfer", {}).get(
                "bytes", 0)

        # heartbeats carry each raylet's wire counters to the driver
        _wait_for(lambda: pulled_bytes("n2"), what="n2's pull counters")
        return {"sum": summed, "sum_on": role.get(ppid, ppid),
                "spread": [v for v, _ in out],
                "placements": dict(placements),
                "num_pulled": {n: pulled(n) for n in nodes},
                "pulled_bytes": {n: pulled_bytes(n) for n in nodes}}
    finally:
        cluster.shutdown()


def test_cluster_scenario_matches_the_reference():
    import ray_tpu
    import ray_tpu_torch
    from ray_tpu.cluster_utils import Cluster as RefCluster
    from ray_tpu.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy as RefAffinity)
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    ref = _scenario(ray_tpu, RefCluster, RefAffinity, num_tpus=0)
    port = _scenario(ray_tpu_torch, Cluster, NodeAffinitySchedulingStrategy,
                     num_gpus=0)
    assert port == ref
    assert port["sum"] == int(_make(ARRAY_ELEMS).sum())
    assert port["sum_on"] == "n2"
    assert port["spread"] == [i * i for i in range(N_SPREAD)]
    assert port["placements"] == {"n1": N_SPREAD // 2, "n2": N_SPREAD // 2}
    assert port["num_pulled"] == {"n1": 0, "n2": 1}
    assert port["pulled_bytes"]["n2"] >= ARRAY_ELEMS * 8


def test_remote_node_with_gpus_is_refused():
    """A remote raylet and its workers see no card, so a remote node may
    not advertise GPUs; a logical node may (its GPU work runs on the
    driver's threads)."""
    import ray_tpu_torch
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(num_gpus=0, head_num_cpus=2)
    try:
        before = ray_tpu_torch.cluster_resources()
        with pytest.raises(ValueError, match="no card"):
            cluster.add_node(num_cpus=1, num_gpus=1, remote=True)
        with pytest.raises(ValueError, match="no card"):
            cluster.add_node(num_cpus=1, resources={"GPU": 2}, remote=True)
        assert ray_tpu_torch.cluster_resources() == before
        assert not cluster.worker.node_group._remote_nodes
        cluster.add_node(num_cpus=1, num_gpus=1)
        assert ray_tpu_torch.cluster_resources()["GPU"] == 1.0
    finally:
        cluster.shutdown()


def _tensor_facts(t):
    import os
    return (type(t).__name__, t.device.type, int(t.sum()),
            os.environ.get("CUDA_VISIBLE_DEVICES"))


def test_device_tier_tensor_reaches_a_remote_worker_as_a_host_copy():
    """A torch tensor ``put`` on a head with a GPU (``init(num_gpus=1)``)
    is held in its device tier; a task pinned to a remote raylet gets a
    CPU tensor through a host copy pulled over the transfer plane, and
    the device copy stays primary. (A task's result never takes the
    device tier, in either package: only ``put`` does.)"""
    import ray_tpu_torch
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    cluster = Cluster(num_gpus=1, head_num_cpus=2)
    try:
        w = cluster.worker
        nid = cluster.add_node(num_cpus=2, remote=True)
        facts = ray_tpu_torch.remote(_tensor_facts)
        held = torch.arange(300_000, dtype=torch.int64) * 7
        ref = ray_tpu_torch.put(held)
        assert w.device_store.contains(ref.id())
        out = ray_tpu_torch.get(facts.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                nid.hex(), soft=False)).remote(ref), timeout=120)
        assert out == ("Tensor", "cpu", int(held.sum()), "")
        assert w.device_store.stats()["num_spilled_to_host"] == 1
        assert ray_tpu_torch.get(ref) is held
        stats = w.node_group._remote_nodes[nid].client.call("stats")
        assert stats["num_pulled"] == 1
    finally:
        cluster.shutdown()
