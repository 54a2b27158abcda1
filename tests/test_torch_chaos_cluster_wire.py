"""The port's object and wire planes under injected faults: the cluster
cases of ``tests/test_chaos.py`` from its raylet killed mid-task on
(its lines 705-1040) on ``ray_tpu_torch`` (the raylet's running task
retried and its lost object rebuilt exactly once, coalesced
``submit_many`` frames severed and duplicated, ``task_done_many``
severed, shed statuses per payload, the wire gauges, worker-owned refs
in fast frames). The earlier cluster cases are in
``test_torch_chaos_cluster.py``.
"""

import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch._private import chaos

BIG = 200_000   # float64 elements ≈ 1.6MB > inline cap


def _wait_for(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _clean_chaos():
    """Every test starts and ends with a disarmed plane and no
    inherited env rules."""
    chaos.clear()
    os.environ.pop(chaos.ENV_VAR, None)
    yield
    chaos.clear()
    os.environ.pop(chaos.ENV_VAR, None)


# ---------------------------------------------------------------------------
# raylet killed mid-task: node dead -> retry + lineage reconstruction


def test_node_killed_mid_task_reconstructs_exactly_once(tmp_path):
    """Acceptance (c): a raylet process chaos-killed mid-task is
    declared dead (channel give-up + GCS health), its running task
    retries on a survivor, and its lost object reconstructs via
    lineage with exactly-once accounting (num_reconstructions == 1,
    creating task ran exactly twice)."""
    ray_tpu_torch.shutdown()
    from ray_tpu_torch._private.config import get_config
    from ray_tpu_torch.cluster_utils import Cluster

    marker = tmp_path / "make_runs.txt"
    cluster = Cluster(num_gpus=0, head_num_cpus=2, _system_config={
        "health_check_period_ms": 200,
        "health_check_failure_threshold": 2,
        "raylet_channel_reconnect_ms": 1500,
    })
    try:
        cluster._ensure_gcs()       # GCS spawns BEFORE chaos is armed
        os.environ[chaos.ENV_VAR] = "raylet.dispatch.stats:kill@1"
        doomed = cluster.add_node(num_cpus=2, resources={"L": 2},
                                  remote=True)
        os.environ.pop(chaos.ENV_VAR)

        @ray_tpu_torch.remote(num_cpus=1, resources={"L": 1})
        def make(path, i):
            with open(path, "a") as f:
                f.write(f"{i}\n")
            return np.full(BIG, i, dtype=np.float64)

        @ray_tpu_torch.remote(num_cpus=1, resources={"L": 1}, max_retries=3)
        def slow(started):
            with open(started, "w"):
                pass
            time.sleep(3.0)
            return "finished"

        ref = make.remote(str(marker), 7)
        ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=60)
        assert ready                    # result lives on the doomed node

        started = tmp_path / "slow_started"
        slow_ref = slow.remote(str(started))
        # let it start executing there
        _wait_for(started.exists, what="the slow task's start")

        # Deterministic mid-task kill: the raylet dies at the dispatch
        # of this stats call (chaos kill-at-point in the raylet).
        handle = cluster.worker.node_group._remote_nodes[doomed]
        with pytest.raises((TimeoutError, ConnectionError)):
            handle.client.call("stats", timeout=3)

        cluster.add_node(num_cpus=2, resources={"L": 2}, remote=True)
        # Node death converges via raylet-channel give-up and/or GCS
        # missed heartbeats -> REMOVED.
        deadline = time.monotonic() + 30
        while (doomed in cluster.worker.node_group._remote_nodes
               and time.monotonic() < deadline):
            time.sleep(0.1)
        assert doomed not in cluster.worker.node_group._remote_nodes
        cluster.worker.node_group.recheck_infeasible()

        # the mid-task kill: the running task retried on the survivor
        assert ray_tpu_torch.get(slow_ref, timeout=120) == "finished"

        # the lost object: reconstructed via lineage, exactly once
        val = ray_tpu_torch.get(ref, timeout=120)
        assert val[0] == 7.0 and val.shape == (BIG,)
        assert cluster.worker.task_manager.num_reconstructions == 1
        assert marker.read_text() == "7\n7\n"   # original + one re-run
    finally:
        os.environ.pop(chaos.ENV_VAR, None)
        cluster.shutdown()
        get_config().reset()


# ---------------------------------------------------------------------------
# data-plane fast path (docs/data_plane.md): chaos on COALESCED frames.
# The batching layers (submit_many gather window, task_done_many
# completion coalescing) must inherit PR-2's contract unchanged: a
# dropped/duplicated/severed frame costs latency, never results —
# exactly-once execution, per-caller completion order, and per-payload
# shed statuses all survive the frames carrying N tasks instead of 1.


def test_severed_coalesced_submit_many_executes_exactly_once(tmp_path):
    """Sever the first coalesced submit_many frame mid-send: the
    retrying channel reconnects and re-sends under the SAME
    idempotency token, so every payload in the frame executes exactly
    once and nothing is lost or doubled."""
    ray_tpu_torch.shutdown()
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch._private.config import get_config

    marker = tmp_path / "ran.txt"
    # a generous gather window makes the burst leave as ONE frame
    cluster = Cluster(num_gpus=0, head_num_cpus=2,
                      _system_config={"submit_coalesce_ms": 20.0})
    try:
        cluster.add_node(num_cpus=4, resources={"B": 4}, remote=True,
                         max_process_workers=2)

        @ray_tpu_torch.remote(num_cpus=0, resources={"B": 0.01})
        def burst(path, i):
            with open(path, "a") as f:
                f.write(f"{i}\n")
            return i

        chaos.install("raylet_channel.send.submit_many:sever@1")
        refs = [burst.remote(str(marker), i) for i in range(16)]
        assert ray_tpu_torch.get(refs, timeout=120) == list(range(16))
        # the fault really hit a COALESCED frame (vacuity guard)
        assert ("raylet_channel", "send", "submit_many",
                "sever") in chaos.events()
        ran = sorted(int(x) for x in marker.read_text().split())
        assert ran == list(range(16))     # exactly once each
        # wire-level retry, not task retry: the frame never reached
        # the raylet, so nothing ran twice and nothing was failed
        assert cluster.worker.task_manager.num_retries == 0
    finally:
        cluster.shutdown()
        get_config().reset()


def test_duplicated_coalesced_submit_many_executes_exactly_once(tmp_path):
    """Double a coalesced submit_many frame on the wire: the server's
    dedupe cache collapses the duplicate CALL to one execution for
    every payload, and the hit is observable in the raylet's
    heartbeat (dedupe hit-rate satellite)."""
    ray_tpu_torch.shutdown()
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch._private.config import get_config

    marker = tmp_path / "ran.txt"
    cluster = Cluster(num_gpus=0, head_num_cpus=2,
                      _system_config={"submit_coalesce_ms": 20.0})
    try:
        nid = cluster.add_node(num_cpus=4, resources={"B": 4},
                               remote=True, max_process_workers=2)

        @ray_tpu_torch.remote(num_cpus=0, resources={"B": 0.01})
        def burst(path, i):
            with open(path, "a") as f:
                f.write(f"{i}\n")
            return i

        chaos.install("raylet_channel.send.submit_many:dup@1")
        refs = [burst.remote(str(marker), i) for i in range(16)]
        assert ray_tpu_torch.get(refs, timeout=120) == list(range(16))
        assert ("raylet_channel", "send", "submit_many",
                "dup") in chaos.events()
        ran = sorted(int(x) for x in marker.read_text().split())
        assert ran == list(range(16))     # dedupe collapsed the dup
        # the dedupe hit surfaces in the raylet's heartbeat stats
        w = cluster.worker
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            entry = w.node_stats.get(nid)
            if entry and entry[1].get("dedupe_hits", 0) >= 1:
                break
            time.sleep(0.2)
        else:
            raise AssertionError(
                "duplicate frame's dedupe hit never surfaced in "
                f"heartbeat stats: {w.node_stats.get(nid)}")
        assert entry[1].get("dedupe_hit_rate", 0.0) > 0.0
    finally:
        cluster.shutdown()
        get_config().reset()


def test_severed_task_done_many_replays_exactly_once_in_order():
    """Sever the first coalesced task_done_many completion frame on
    the raylet side: the payloads land in the PR-2 replay buffer, the
    owner's retrying channel reconnects + re-registers, and the
    replayed completions arrive exactly once in per-caller order (the
    counter's strictly increasing returns prove both)."""
    ray_tpu_torch.shutdown()
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch._private.config import get_config

    # rule rides the env into the spawned raylet process; popped
    # right after spawn so nothing else arms it
    os.environ[chaos.ENV_VAR] = "raylet.send.task_done_many:sever@1"
    cluster = Cluster(num_gpus=0, head_num_cpus=2,
                      _system_config={"task_done_coalesce_ms": 20.0})
    try:
        nid = cluster.add_node(num_cpus=2, resources={"S": 2},
                               remote=True, max_process_workers=1)
        os.environ.pop(chaos.ENV_VAR, None)

        @ray_tpu_torch.remote(num_cpus=0, resources={"S": 0.01})
        class Counter:
            def __init__(self):
                self.n = 0

            def inc(self):
                self.n += 1
                return self.n

        a = Counter.remote()
        refs = [a.inc.remote() for _ in range(30)]
        # exactly-once AND ordered: a doubled call would break the
        # 1..30 sequence, a lost completion would hang the get
        assert ray_tpu_torch.get(refs, timeout=120) == list(range(1, 31))
        w = cluster.worker
        handle = w.node_group._remote_nodes[nid]
        # the sever really fired (the rule only matches a COALESCED
        # completion frame) and cost one reconnect, nothing else
        deadline = time.monotonic() + 10
        while (handle.client.num_reconnects < 1
               and time.monotonic() < deadline):
            time.sleep(0.1)
        assert handle.client.num_reconnects >= 1
        assert w.task_manager.num_retries == 0
    finally:
        os.environ.pop(chaos.ENV_VAR, None)
        cluster.shutdown()
        get_config().reset()


def test_shed_statuses_in_coalesced_frame_honored_per_payload(tmp_path):
    """A burst bigger than the raylet's bounded intake leaves as one
    coalesced submit_many frame whose reply mixes admitted and shed
    statuses: the owner honors each PER PAYLOAD — shed tasks retry
    after backoff, admitted tasks run once, nothing is lost."""
    ray_tpu_torch.shutdown()
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch._private.config import get_config

    marker = tmp_path / "ran.txt"
    cluster = Cluster(num_gpus=0, head_num_cpus=2, _system_config={
        "submit_coalesce_ms": 20.0,
        "raylet_max_queued_tasks": 4,
        "backpressure_retry_base_ms": 20,
        "backpressure_retry_max_ms": 200,
    })
    try:
        cluster.add_node(num_cpus=4, resources={"B": 4}, remote=True,
                         max_process_workers=2)

        @ray_tpu_torch.remote(num_cpus=0, resources={"B": 0.01})
        def burst(path, i):
            time.sleep(0.05)
            with open(path, "a") as f:
                f.write(f"{i}\n")
            return i

        refs = [burst.remote(str(marker), i) for i in range(16)]
        assert ray_tpu_torch.get(refs, timeout=120) == list(range(16))
        ran = sorted(int(x) for x in marker.read_text().split())
        assert ran == list(range(16))     # exactly once each
        w = cluster.worker
        # the burst hit the bounded intake through coalesced frames:
        # sheds were honored per payload (not whole-frame requeues)
        assert w.node_group.num_shed > 0
        lease = w.node_group.wire_stats.channel("lease_rpc")
        assert lease.payloads > lease.frames   # >=1 frame carried >1
        assert w.task_manager.num_retries == 0
    finally:
        cluster.shutdown()
        get_config().reset()


def test_wire_plane_gauges_move_under_batched_workload():
    """Observability satellite: ray_tpu_rpc_batch_size{channel},
    ray_tpu_rpc_fastframe_hits, and the per-node heartbeat wire stats
    all move when a batched workload runs."""
    ray_tpu_torch.shutdown()
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch._private.config import get_config

    cluster = Cluster(num_gpus=0, head_num_cpus=2,
                      _system_config={"submit_coalesce_ms": 20.0})
    try:
        nid = cluster.add_node(num_cpus=4, resources={"B": 4},
                               remote=True, max_process_workers=2)

        @ray_tpu_torch.remote(num_cpus=0, resources={"B": 0.01})
        def f(i):
            return i

        assert ray_tpu_torch.get([f.remote(i) for i in range(64)],
                           timeout=120) == list(range(64))
        w = cluster.worker
        # wait one heartbeat so the raylet's wire sub-dict arrives
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            entry = w.node_stats.get(nid)
            if entry and isinstance(entry[1].get("wire"), dict):
                break
            time.sleep(0.2)
        else:
            raise AssertionError("heartbeat never carried wire stats")

        from ray_tpu_torch.util import metrics
        text = metrics.prometheus_text()
        batch_lines = [ln for ln in text.splitlines()
                       if ln.startswith("ray_tpu_rpc_batch_size")]
        assert any('channel="lease_rpc"' in ln and
                   float(ln.split()[-1]) > 1.0 for ln in batch_lines), \
            batch_lines
        ff_lines = [ln for ln in text.splitlines()
                    if ln.startswith("ray_tpu_rpc_fastframe_hits")
                    and not ln.startswith("#")]
        assert ff_lines and float(ff_lines[0].split()[-1]) > 0
    finally:
        cluster.shutdown()
        get_config().reset()


def test_fastframe_preserves_worker_owned_contained_refs():
    """Regression: a worker-owned contained ref rides the completion
    push as a (bytes, owner_addr) pair; on the negotiated binary
    small-frame path msgpack normalizes the pair to a LIST, and the
    owner's containment adoption must accept both spellings — the
    original tuple-only gate crashed the push handler, hanging the
    get() and leaking the pre-registered borrow."""
    ray_tpu_torch.shutdown()
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(num_gpus=0, head_num_cpus=1)
    try:
        cluster.add_node(num_cpus=2, resources={"V": 2}, remote=True,
                         max_process_workers=1)

        @ray_tpu_torch.remote(num_cpus=0, resources={"V": 0.01})
        def maker():
            inner = ray_tpu_torch.put("worker-owned-value")
            return {"ref": inner}

        out = ray_tpu_torch.get(maker.remote(), timeout=60)
        assert ray_tpu_torch.get(out["ref"],
                           timeout=60) == "worker-owned-value"
        # the small result really rode the fast path (vacuity guard)
        from ray_tpu_torch._private import wire_stats
        snap = wire_stats.snapshot()
        assert snap.get("rpcin:raylet_channel",
                        {}).get("fastframe_hits", 0) > 0
    finally:
        cluster.shutdown()
