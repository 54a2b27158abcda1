"""The port's runtime under injected faults: the cluster cases of
``tests/test_chaos.py`` (its lines 334-704) on ``ray_tpu_torch`` (a
severed GCS connection that reconnects and re-registers, a severed owner
channel that still delivers, workers and actors killed mid-task, a kill
that wins over a restart, a GCS killed and restarted with its state, the
health loop's pruning, the final snapshot). Its later cases are in
``test_torch_chaos_cluster_wire.py``.
"""

import os
import time

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private.rpc import RpcServer

def _wait_for(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


def _snapshot_has(session, key, value):
    """Whether the GCS process's persisted snapshot holds ``key``."""
    from ray_tpu_torch._private.gcs import GcsLite
    from ray_tpu_torch._private.session_dir import session_dir
    try:
        with open(session_dir(session, "gcs_state.bin"), "rb") as f:
            blob = f.read()
    except FileNotFoundError:
        return False
    state = GcsLite()
    state.load_state(blob)
    return state.kv_get(key, "ns") == value


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


def test_severed_gcs_connection_reconnects_and_reregisters():
    """Acceptance (a): a severed GCS connection recovers via backoff
    reconnect; subscriptions resume on the new connection and the
    external on_reconnect hook (the raylet's re-register) fires."""
    from ray_tpu_torch._private.gcs import NodeInfo
    from ray_tpu_torch._private.gcs_client import GcsClient
    from ray_tpu_torch._private.gcs_server import GcsServer
    from ray_tpu_torch._private.ids import NodeID

    server = GcsServer()
    client = GcsClient(server.address)
    try:
        reregistered = []
        client.on_reconnect = lambda: reregistered.append(1)
        events = []
        client.publisher.subscribe("NODE", events.append)

        client.kv_put(b"alpha", b"1", "ns")
        chaos.install("gcs_client.send.kv_get:sever@1")
        assert client.kv_get(b"alpha", "ns") == b"1"
        assert client.num_reconnects == 1
        assert reregistered == [1]

        # pushes ride the re-established subscription
        server._register_node(
            None, NodeInfo(node_id=NodeID.from_random(),
                           resources_total={"CPU": 1.0}), None)
        deadline = time.monotonic() + 10
        while not events and time.monotonic() < deadline:
            time.sleep(0.02)
        assert events and events[0][0] == "ADDED"
    finally:
        client.close()
        server.shutdown()


# ---------------------------------------------------------------------------
# owner<->raylet channel: a survived sever loses nothing


def test_severed_owner_channel_delivers_completion_after_reconnect():
    """Sever the owner->raylet channel while a task is executing on
    the raylet: the channel reconnects and re-registers, the raylet's
    disconnect grace spares the task's routing state (adopted by the
    new connection), and the completion still arrives — the node is
    NOT declared lost and the task does not re-run."""
    ray_tpu_torch.shutdown()
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(num_gpus=0, head_num_cpus=2)
    try:
        nid = cluster.add_node(num_cpus=2, resources={"S": 2},
                               remote=True)

        @ray_tpu_torch.remote(num_cpus=1, resources={"S": 1})
        def slowish():
            time.sleep(1.5)
            return "delivered"

        ref = slowish.remote()
        handle = cluster.worker.node_group._remote_nodes[nid]
        _wait_for(lambda: handle.client.call("stats")["running"] >= 1,
                  what="the task executing on the raylet")
        # Sever the channel from the driver side: the next stats send
        # dies mid-frame, killing the connection under the channel.
        chaos.install("raylet_channel.send.stats:sever@1")
        stats = handle.client.call("stats", timeout=15)
        assert stats["node_id"] == nid.hex()   # retried transparently
        assert handle.client.num_reconnects == 1

        assert ray_tpu_torch.get(ref, timeout=60) == "delivered"
        # the sever cost latency, not the node and not a re-execution
        assert nid in cluster.worker.node_group._remote_nodes
        assert cluster.worker.task_manager.num_retries == 0
        assert cluster.worker.task_manager.num_reconstructions == 0
    finally:
        cluster.shutdown()


# ---------------------------------------------------------------------------
# worker killed mid-task (chaos kill-at-point in the worker process)


def test_worker_killed_mid_task_retries_exactly_once(tmp_path):
    """Satellite: kill a worker at task entry via the chaos plane; the
    task completes on retry with num_retries == 1 and exactly one side
    effect (the killed attempt died before user code ran)."""
    ray_tpu_torch.shutdown()
    marker = tmp_path / "sides.txt"
    w = ray_tpu_torch.init(num_gpus=0, num_cpus=2, max_process_workers=2)
    try:
        # Arm ONLY the first worker: spawn it with the rule in its
        # env, wait for registration, then disarm — the retry's fresh
        # worker spawns clean (per-process rule state would otherwise
        # kill every attempt).
        head = w.node_group._raylets[w.node_group.head_node_id]
        os.environ[chaos.ENV_VAR] = "worker.exec.chaos_victim:kill@1"
        head.worker_pool.prestart(1)
        deadline = time.monotonic() + 60
        while (head.worker_pool.stats()["idle_process"] < 1
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert head.worker_pool.stats()["idle_process"] >= 1
        os.environ.pop(chaos.ENV_VAR)

        @ray_tpu_torch.remote
        def victim(path):
            with open(path, "a") as f:
                f.write("x\n")
            return "done"

        ref = victim.options(name="chaos_victim").remote(str(marker))
        assert ray_tpu_torch.get(ref, timeout=120) == "done"
        assert marker.read_text() == "x\n"      # exactly one side effect
        assert w.task_manager.num_retries == 1
    finally:
        os.environ.pop(chaos.ENV_VAR, None)
        ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# actor chaos-killed mid-method: retries replay in per-caller order


def test_actor_chaos_kill_replays_calls_in_order(tmp_path):
    """Satellite: chaos-kill an actor's worker at the 3rd method exec;
    with max_restarts + max_task_retries the actor restarts and every
    in-flight/queued call replays — in per-caller submission order
    (sequence_number), with exactly one side effect per call (the
    killed attempt died at exec entry, before user code ran)."""
    ray_tpu_torch.shutdown()
    marker = tmp_path / "order.txt"
    # one-process pool: the pool spawns ahead during creation retries,
    # and a second worker spawned while the env rule is set would stay
    # armed and kill the RESTARTED actor too
    w = ray_tpu_torch.init(num_gpus=0, num_cpus=2, max_process_workers=1)
    try:
        @ray_tpu_torch.remote(max_restarts=1, max_task_retries=2)
        class Seq:
            def ping(self):
                return "up"

            def mark(self, path, i):
                with open(path, "a") as f:
                    f.write(f"{i}\n")
                return i

        # Arm ONLY this actor's worker: rule rides the env into the
        # spawn; the restarted worker spawns clean after the pop.
        os.environ[chaos.ENV_VAR] = "worker.exec.Seq.mark:kill@3"
        a = Seq.remote()
        assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == "up"
        os.environ.pop(chaos.ENV_VAR)

        refs = [a.mark.remote(str(marker), i) for i in range(8)]
        assert ray_tpu_torch.get(refs, timeout=120) == list(range(8))
        # per-caller ordering survived the restart: the failed batch
        # re-queued by sequence_number, not reversed
        assert marker.read_text().splitlines() == [str(i)
                                                   for i in range(8)]
        assert w.task_manager.num_retries >= 1
        info = w.gcs.get_actor_info(a._actor_id)
        assert info.num_restarts == 1
    finally:
        os.environ.pop(chaos.ENV_VAR, None)
        ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# kill/restart race: ray_tpu_torch.kill() must beat an in-flight restart


def test_kill_wins_over_inflight_restart(tmp_path):
    """Satellite regression: kill_actor zeroes the restart budget, but
    a creation spec already resubmitted by _on_actor_death could
    complete afterwards and revive the actor. The kill tombstone must
    win: the actor stays DEAD and the revived worker is reaped."""
    ray_tpu_torch.shutdown()
    gate = tmp_path / "slow_restart"
    w = ray_tpu_torch.init(num_gpus=0, num_cpus=2, max_process_workers=2)
    try:
        @ray_tpu_torch.remote(max_restarts=5)
        class Phoenix:
            def __init__(self, gate):
                import os as _os
                import time as _time
                if _os.path.exists(gate):   # slow on RESTART only
                    _time.sleep(1.5)
                    with open(gate + ".landed", "w"):
                        pass

            def ping(self):
                return "alive"

        a = Phoenix.remote(str(gate))
        assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == "alive"
        gate.write_text("x")

        # crash the worker abruptly: _on_actor_death resubmits the
        # (now slow) creation spec
        worker = w.node_group.actor_worker(a._actor_id)
        worker.proc.kill()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            info = w.gcs.get_actor_info(a._actor_id)
            if info.state == "RESTARTING":
                break
            time.sleep(0.02)
        assert w.gcs.get_actor_info(a._actor_id).state == "RESTARTING"

        ray_tpu_torch.kill(a)     # while the resubmitted creation is in flight
        # let the slow creation land (and lose)
        _wait_for(lambda: os.path.exists(str(gate) + ".landed"),
                  what="the restarted creation")
        _wait_for(lambda: (w.gcs.get_actor_info(a._actor_id).state == "DEAD"
                           and w.node_group.actor_worker(a._actor_id)
                           is None),
                  what="the revived worker reaped")
        from ray_tpu_torch.exceptions import ActorDiedError
        with pytest.raises(ActorDiedError):
            ray_tpu_torch.get(a.ping.remote(), timeout=30)
    finally:
        ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# gcs chaos-killed and restarted: re-registration + durable state


def test_gcs_killed_and_restarted_state_survives():
    """Chaos-kill the spawned GCS process, restart it on the SAME port
    against the same persist_path: raylets re-register through their
    retrying channels, heartbeats flow end-to-end again, named actors
    stay resolvable, and KV state survives the restart."""
    ray_tpu_torch.shutdown()
    from ray_tpu_torch._private.config import get_config
    from ray_tpu_torch._private.gcs_server import spawn_gcs_process
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(num_gpus=0, head_num_cpus=2, _system_config={
        "gcs_mode": "process",
        "health_check_period_ms": 200,
        # armed in every process, but the component only matches the
        # GCS server's dispatch — a poison kv_del kills it on demand
        "chaos_rules": "gcs.dispatch.kv_del:kill@1",
    })
    try:
        w = cluster.worker
        nid = cluster.add_node(num_cpus=2, resources={"G": 2},
                               remote=True)

        @ray_tpu_torch.remote
        class Survivor:
            def ping(self):
                return "alive"

        actor = Survivor.options(name="survivor", lifetime="detached",
                                 resources={"G": 1}).remote()
        assert ray_tpu_torch.get(actor.ping.remote(), timeout=60) == "alive"
        w.gcs.kv_put(b"durable", b"payload", "ns")
        _wait_for(lambda: _snapshot_has(w.session, b"durable", b"payload"),
                  what="the persist loop's snapshot of the put")

        old_addr = tuple(w.gcs_address)
        proc1 = w._gcs_proc
        try:
            # dispatching this kills the GCS (chaos kill-at-point);
            # the short deadline abandons the call without retrying it
            # into the restarted server
            w.gcs._call("kv_del", b"sacrifice", "ns", timeout=3)
        except Exception:
            pass
        deadline = time.monotonic() + 10
        while proc1.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert proc1.poll() == chaos.KILL_EXIT_CODE

        # restart against the same persist_path, on the same port, so
        # every retrying client reconnects without re-discovery
        t_restart = time.time()
        proc2, addr2 = spawn_gcs_process(
            w.session, get_config().serialize(), persist=True,
            port=old_addr[1])
        w._gcs_proc = proc2          # worker.shutdown reaps it
        assert tuple(addr2) == old_addr

        # the raylet re-registered (GcsClient on_reconnect) and its
        # heartbeats flow through the restarted GCS to the driver's
        # re-subscribed channel — end-to-end proof of re-registration
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            ts, _ = w.node_reports.get(nid, (0, None))
            if ts > t_restart:
                break
            time.sleep(0.1)
        assert w.node_reports.get(nid, (0, None))[0] > t_restart

        # KV survived the kill
        assert w.gcs.kv_get(b"durable", "ns") == b"payload"
        # the named actor is still resolvable AND callable
        again = ray_tpu_torch.get_actor("survivor")
        assert ray_tpu_torch.get(again.ping.remote(), timeout=60) == "alive"
    finally:
        cluster.shutdown()
        get_config().reset()


# ---------------------------------------------------------------------------
# gcs server hygiene (satellite fixes)


def test_gcs_health_loop_prunes_dead_node_clients():
    """A node declared dead must not leak its health-probe client
    (socket + reader thread) for the GCS's lifetime."""
    from ray_tpu_torch._private.config import get_config
    from ray_tpu_torch._private.gcs import NodeInfo
    from ray_tpu_torch._private.gcs_server import GcsServer
    from ray_tpu_torch._private.ids import NodeID

    get_config().apply_system_config({
        "health_check_period_ms": 100,
        "health_check_failure_threshold": 2,
    })
    try:
        gcs = GcsServer()
        victim = RpcServer(component="doomed_raylet")
        node_id = NodeID.from_random()
        try:
            gcs._register_node(
                None, NodeInfo(node_id=node_id,
                               resources_total={"CPU": 1.0}),
                victim.address)
            deadline = time.monotonic() + 10
            while node_id not in gcs._health_clients \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            assert node_id in gcs._health_clients
            victim.shutdown()       # node dies; pings start failing
            deadline = time.monotonic() + 15
            while node_id in gcs._health_clients \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            assert node_id not in gcs._health_clients   # pruned+closed
            assert all(not i.alive
                       for i in gcs.state.get_all_node_info()
                       if i.node_id == node_id)
        finally:
            victim.shutdown()
            gcs.shutdown()
    finally:
        get_config().reset()


def test_gcs_shutdown_flushes_final_snapshot(tmp_path):
    """A mutation landing right before shutdown must reach the
    snapshot — the persist thread flushes once more on exit and
    shutdown joins it."""
    from ray_tpu_torch._private.gcs_server import GcsServer

    path = str(tmp_path / "gcs_state.bin")
    gcs = GcsServer(persist_path=path)
    try:
        gcs.state.kv_put(b"last", b"write", "ns")
        gcs._dirty.set()     # as the mutating handler wrapper would
    finally:
        gcs.shutdown()       # immediately: inside the 0.2s window
    reborn = GcsServer(persist_path=path)
    try:
        assert reborn.state.kv_get(b"last", "ns") == b"write"
    finally:
        reborn.shutdown()
