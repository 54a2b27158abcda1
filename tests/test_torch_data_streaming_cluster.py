"""The two ``Cluster`` cases of ``tests/test_data_streaming.py`` on both
packages: a chaos-severed block transfer that the pull engine re-drives
without a hang, and an actor pool's locality routing to the raylet that
holds a block's bytes. Each package runs its own ``Cluster`` with one
remote raylet (the port's with ``num_gpus=0``), one after the other, and
the port is held to the reference's assertions and row values."""

import time

import pytest

import ray_tpu
import ray_tpu_torch
from tests.test_torch_data import _few_threads, data_of, mod  # noqa: F401

PACKAGES = ((ray_tpu, {}), (ray_tpu_torch, {"num_gpus": 0}))


@pytest.fixture(autouse=True)
def _no_live_runtime():
    for rt, _ in PACKAGES:
        rt.shutdown()
    yield


def _on_clusters(scenario):
    outs = []
    for rt, kw in PACKAGES:
        cluster = mod(rt, "cluster_utils").Cluster(head_num_cpus=0, **kw)
        try:
            cluster.add_node(num_cpus=4, remote=True,
                             object_store_memory=256 * 1024 * 1024)
            outs.append(scenario(rt, data_of(rt), cluster))
        finally:
            mod(rt, "_private.chaos").clear()
            cluster.shutdown()
    return outs


def test_sever_block_transfer_retries_no_hang():
    """Chaos-sever the first cross-node block fetch: the pull engine
    prunes the dead peer, re-dials, and re-drives the fetch — the
    block arrives without burning a lineage reconstruction, and
    consumption completes within the deadline (retry, not hang)."""
    rows = 65536                        # 512 KiB blocks: real pulls

    def scenario(rt, rdata, cluster):
        chaos = mod(rt, "_private.chaos")
        object_transfer = mod(rt, "_private.object_transfer")
        object_transfer.reset_counters()
        # every map output lives on the remote node; consuming on the
        # driver pulls it over the transfer plane (fetch_chunk)
        chaos.install("*.send.fetch_chunk:sever@1")
        ds = rdata.range(rows * 2, parallelism=2).map_batches(
            lambda b: {"id": b["id"]})
        t0 = time.monotonic()
        got = []
        for batch in ds.iter_batches(batch_size=rows):
            got.extend(batch["id"].tolist())
        return {"seconds": time.monotonic() - t0, "rows": sorted(got),
                "fired": any(e[1:] == ("send", "fetch_chunk", "sever")
                             for e in chaos.events()),
                "pulls": object_transfer.pull_counters(),
                "reconstructions":
                cluster.worker.task_manager.num_reconstructions}

    ref, got = _on_clusters(scenario)
    assert got["seconds"] < 90, "sever turned into a hang"
    assert got["rows"] == list(range(rows * 2)) == ref["rows"]
    # the sever actually fired on the wire ...
    assert got["fired"] and ref["fired"]
    # ... and the transfer layer absorbed it: the driver's pulls re-drove
    # the fetch instead of failing the block back to lineage
    assert got["pulls"]["started"] >= 1
    assert got["pulls"]["failed"] == 0
    assert got["reconstructions"] == 0 == ref["reconstructions"]


def test_locality_routing_prefers_colocated_actor():
    """Blocks produced on the (only) CPU-bearing node route to the
    pool actor living there: the router's hit counter moves."""
    rows = 65536                        # > inline: remote entries

    def scenario(rt, rdata, cluster):
        data_stats = mod(rt, "_private.data_stats")

        class Ident:
            def __call__(self, batch):
                return {"id": batch["id"]}

        before = data_stats.snapshot()
        ds = rdata.range(rows * 4, parallelism=4).map_batches(
            Ident, concurrency=2)
        n = sum(len(b["id"]) for b in ds.iter_batches(batch_size=rows))
        after = data_stats.snapshot()
        return n, after["locality_hits"] - before["locality_hits"]

    ref, got = _on_clusters(scenario)
    assert got[0] == rows * 4 == ref[0]
    assert got[1] >= 1, "no block was routed to a co-located pool actor"
