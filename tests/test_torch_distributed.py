"""The port's wire RPC and standalone GCS process: the RPC and GCS cases
of ``tests/test_distributed.py`` on ``ray_tpu_torch`` (calls, pushes and
errors over the wire, token and version refusals, a GCS process with
pub/sub, persisted state across a restart, a client that survives it,
health checks that declare a silent node dead, ``gcs_mode="process"``
end to end). Its ``ray_start_cluster`` cases are in
``test_torch_distributed_cluster.py``.
"""

import os
import time

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.rpc import RpcClient, RpcError, RpcServer


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _wait_for(cond, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


# ---------------------------------------------------------------------------
# RPC layer


def test_rpc_call_oneway_push_error():
    server = RpcServer()
    got = []

    def echo(ctx, x):
        return x * 2

    def boom(ctx):
        raise ValueError("nope")

    def subscribe(ctx):
        ctx.push("news", "hello")
        return "subscribed"

    server.register("echo", echo)
    server.register("boom", boom)
    server.register("note", lambda ctx, m: got.append(m))
    server.register("subscribe", subscribe)

    pushes = []
    client = RpcClient(server.address,
                       on_push=lambda t, p: pushes.append((t, p)))
    assert client.call("echo", 21) == 42
    with pytest.raises(RpcError, match="nope"):
        client.call("boom")
    client.oneway("note", "fire-and-forget")
    assert client.call("subscribe") == "subscribed"
    deadline = time.monotonic() + 5
    while (not pushes or not got) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pushes == [("news", "hello")]
    assert got == ["fire-and-forget"]
    client.close()
    server.shutdown()


def test_rpc_large_payload_roundtrip():
    server = RpcServer()
    server.register("echo_len", lambda ctx, b: len(b))
    client = RpcClient(server.address)
    blob = b"x" * (8 * 1024 * 1024)
    assert client.call("echo_len", blob) == len(blob)
    client.close()
    server.shutdown()


def test_rpc_token_and_version_refusals():
    """Wrong-token and stale-version clients both get explicit,
    named refusals — never a hang or a pickle error."""
    import pickle
    import socket

    from ray_tpu_torch._private import rpc as rpc_mod
    from ray_tpu_torch._private.rpc import ProtocolError

    server = RpcServer(token="sekrit")
    server.register("ping", lambda ctx: "pong")
    try:
        good = RpcClient(server.address, token="sekrit")
        assert good.call("ping") == "pong"
        good.close()

        with pytest.raises(ProtocolError, match="token"):
            RpcClient(server.address, token="wrong")
        with pytest.raises(ProtocolError, match="token"):
            RpcClient(server.address, token="")   # token-less client

        # Stale-version peer: frame carries an older magic version byte.
        sock = socket.create_connection(server.address, timeout=5)
        data = pickle.dumps(("hello", 0, "sekrit"), protocol=5)
        sock.sendall(rpc_mod._HDR.pack(b"RTP\x00", len(data)) + data)
        magic, length = rpc_mod._HDR.unpack(
            rpc_mod._recv_exact(sock, rpc_mod._HDR.size))
        assert magic == rpc_mod._MAGIC
        reply = pickle.loads(rpc_mod._recv_exact(sock, length))
        assert reply[0] == "hello_err"
        assert "version" in reply[1]
        sock.close()
    finally:
        server.shutdown()


def test_rpc_unpicklable_reply_keeps_connection():
    """A handler returning an unpicklable value must error just that
    call, not tear down the socket with every in-flight call on it."""
    server = RpcServer()
    server.register("bad", lambda ctx: lambda: None)   # lambdas: unpicklable
    server.register("ping", lambda ctx: "pong")
    client = RpcClient(server.address)
    try:
        with pytest.raises(RpcError, match="unserializable"):
            client.call("bad")
        assert client.call("ping") == "pong"   # connection survived
    finally:
        client.close()
        server.shutdown()


# ---------------------------------------------------------------------------
# GCS server process


def test_gcs_process_roundtrip_and_pubsub():
    from ray_tpu_torch._private.gcs import NodeInfo
    from ray_tpu_torch._private.gcs_client import GcsClient
    from ray_tpu_torch._private.gcs_server import spawn_gcs_process

    proc, addr = spawn_gcs_process("gcstest" + str(time.time_ns() % 10_000))
    try:
        c1 = GcsClient(addr)
        c2 = GcsClient(addr)
        events = []
        c2.publisher.subscribe("NODE", events.append)

        nid = NodeID.from_random()
        c1.register_node(NodeInfo(node_id=nid,
                                  resources_total={"CPU": 4.0}))
        deadline = time.monotonic() + 5
        while not events and time.monotonic() < deadline:
            time.sleep(0.01)
        assert events and events[0][0] == "ADDED"
        assert [n.node_id for n in c2.get_all_node_info()] == [nid]

        c1.kv_put(b"k", b"v", "ns")
        assert c2.kv_get(b"k", "ns") == b"v"
        assert c2.kv_keys(b"", "ns") == [b"k"]
        assert c1.next_job_id() == 1
        assert c2.next_job_id() == 2
        c1.close()
        c2.close()
    finally:
        proc.terminate()


def test_gcs_restart_recovers_persisted_state(tmp_path):
    """A restarted GCS (persist_path) comes back knowing its tables —
    the role of the reference's Redis-backed GcsTableStorage."""
    from ray_tpu_torch._private.gcs import NodeInfo
    from ray_tpu_torch._private.gcs_server import GcsServer

    path = str(tmp_path / "gcs_state.bin")
    server = GcsServer(persist_path=path)
    nid = NodeID.from_random()
    server._register_node(None, NodeInfo(node_id=nid,
                                         resources_total={"CPU": 8.0}),
                          None)
    server.state.kv_put(b"model", b"v7", "ns")
    server._dirty.set()
    _wait_for(lambda: os.path.exists(path), what="the first snapshot")
    # shutdown's last flush writes whatever the loop has not yet
    server.shutdown()

    reborn = GcsServer(persist_path=path)
    try:
        assert [n.node_id for n in reborn.state.get_all_node_info()] \
            == [nid]
        assert reborn.state.kv_get(b"model", "ns") == b"v7"
    finally:
        reborn.shutdown()


def test_gcs_client_survives_gcs_restart(tmp_path):
    """Clients reconnect to a restarted GCS and see its persisted
    tables (reference: test_gcs_fault_tolerance semantics)."""
    import socket

    from ray_tpu_torch._private.gcs_client import GcsClient
    from ray_tpu_torch._private.gcs_server import GcsServer

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    path = str(tmp_path / "gcs_state.bin")

    server = GcsServer(port=port, persist_path=path)
    client = GcsClient(("127.0.0.1", port))
    client.kv_put(b"alpha", b"1", "ns")
    server.shutdown()        # its last flush snapshots the put

    reborn = GcsServer(port=port, persist_path=path)
    try:
        # same client object: the dead connection reconnects + retries
        assert client.kv_get(b"alpha", "ns") == b"1"
        client.kv_put(b"beta", b"2", "ns")
        assert reborn.state.kv_get(b"beta", "ns") == b"2"
        client.close()
    finally:
        reborn.shutdown()


def test_gcs_health_check_declares_silent_node_dead():
    """A node registered with an unreachable RPC address is declared
    dead after health_check_failure_threshold missed pings."""
    from ray_tpu_torch._private.gcs import NodeInfo
    from ray_tpu_torch._private.gcs_server import GcsServer
    from ray_tpu_torch._private.config import get_config

    cfg = get_config()
    cfg.apply_system_config({"health_check_period_ms": 100,
                             "health_check_failure_threshold": 2})
    try:
        server = GcsServer()
        events = []
        server.state.publisher.subscribe("NODE", events.append)
        nid = NodeID.from_random()
        # port 1 on localhost: connection refused -> ping failure
        server._register_node(None, NodeInfo(node_id=nid,
                                             resources_total={"CPU": 1.0}),
                              ("127.0.0.1", 1))
        deadline = time.monotonic() + 10
        removed = False
        while time.monotonic() < deadline:
            if any(e[0] == "REMOVED" for e in events):
                removed = True
                break
            time.sleep(0.05)
        assert removed, f"node never declared dead; events={events}"
        infos = {n.node_id: n for n in server.state.get_all_node_info()}
        assert not infos[nid].alive
        server.shutdown()
    finally:
        cfg.reset()


def test_gcs_process_mode_end_to_end():
    """gcs_mode=process: the whole driver runtime (actor registry,
    named lookup) runs against the standalone GCS process."""
    w = ray_tpu_torch.init(num_gpus=0, num_cpus=4, max_process_workers=2,
                     _system_config={"gcs_mode": "process"})
    try:
        from ray_tpu_torch._private.gcs_client import GcsClient
        assert isinstance(w.gcs, GcsClient)

        @ray_tpu_torch.remote
        class Greeter:
            def hi(self):
                return "hi"

        a = Greeter.options(name="greeter").remote()
        assert ray_tpu_torch.get(a.hi.remote()) == "hi"
        b = ray_tpu_torch.get_actor("greeter")
        assert ray_tpu_torch.get(b.hi.remote()) == "hi"
    finally:
        ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# raylet processes end-to-end




def _persisted_alive(path, nid):
    from ray_tpu_torch._private.gcs import GcsLite
    state = GcsLite()
    with open(path, "rb") as f:
        state.load_state(f.read())
    return {n.node_id: n.alive for n in state.get_all_node_info()}.get(nid)


def test_gcs_restart_keeps_health_verdicts(tmp_path):
    """The port's two repairs of the GCS's persistence (both faults are
    in the reference's ``gcs_server.py``): a node the health loop
    declares dead is persisted dead, and a restored node that no longer
    answers is health-checked again and declared dead."""
    from ray_tpu_torch._private.config import get_config
    from ray_tpu_torch._private.gcs import NodeInfo
    from ray_tpu_torch._private.gcs_server import GcsServer

    cfg = get_config()
    path = str(tmp_path / "gcs_state.bin")
    dead, silent = NodeID.from_random(), NodeID.from_random()
    cfg.apply_system_config({"health_check_period_ms": 100,
                             "health_check_failure_threshold": 2})
    try:
        server = GcsServer(persist_path=path)
        # port 1 on localhost: connection refused -> ping failure
        server._register_node(None, NodeInfo(node_id=dead,
                                             resources_total={"CPU": 1.0}),
                              ("127.0.0.1", 1))
        _wait_for(lambda: os.path.exists(path)
                  and _persisted_alive(path, dead) is False,
                  what="the death in the snapshot")
        server.shutdown()
        # a node that was alive when the GCS went down, and whose raylet
        # never comes back
        server = GcsServer(persist_path=path)
        server.state.register_node(NodeInfo(node_id=silent,
                                            resources_total={"CPU": 1.0},
                                            rpc_addr=("127.0.0.1", 1)))
        server._dirty.set()
        server.shutdown()            # its last flush persists the node

        reborn = GcsServer(persist_path=path)
        try:
            alive = lambda: {n.node_id: n.alive  # noqa: E731
                             for n in reborn.state.get_all_node_info()}
            assert alive()[dead] is False
            _wait_for(lambda: alive()[silent] is False,
                      what="the silent restored node declared dead")
        finally:
            reborn.shutdown()
    finally:
        cfg.reset()
