"""Standalone GCS server process.

Reference: ``src/ray/gcs/gcs_server/`` — GcsServer hosting node/actor/
KV managers, GcsPublisher, and GcsHealthCheckManager [UNVERIFIED —
mount empty, SURVEY.md §0]. This process wraps the same ``GcsLite``
tables behind the wire RPC layer (``rpc.py``) and adds the two things
an in-process GCS cannot have: subscribers in OTHER processes (push
channels) and liveness authority (periodic health pings to every
registered raylet; a node missing ``health_check_failure_threshold``
consecutive pings is declared dead and its removal is published).

Run as a process via ``spawn_gcs_process`` (port handshake through a
file) or embedded via ``GcsServer`` (tests).

The port's copy of ``ray_tpu/_private/gcs_server.py``. Its process files
(address, log, persisted state) live in the session directory under
``TMPDIR`` (``session_dir.py``), and the process sees no card: it never
imports torch.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.gcs import GcsLite, NodeInfo
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.rpc import ConnectionContext, RpcClient, RpcServer
from ray_tpu_torch._private.session_dir import session_dir

logger = logging.getLogger(__name__)


class GcsServer:
    """RPC surface + health manager around GcsLite.

    ``persist_path`` makes the tables restart-tolerant (the role of the
    reference's Redis-backed GcsTableStorage): state snapshots to the
    file after every mutation batch and reloads on start, so a
    restarted GCS comes back knowing its nodes, actors, and KV.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 persist_path: Optional[str] = None):
        from ray_tpu_torch._private import chaos
        chaos.maybe_arm()
        self.state = GcsLite()
        self._persist_path = persist_path
        restored = False
        if persist_path and os.path.exists(persist_path):
            try:
                with open(persist_path, "rb") as f:
                    self.state.load_state(f.read())
                restored = True
                logger.info("gcs state restored from %s", persist_path)
            except Exception:
                logger.exception("gcs state restore failed; starting "
                                 "fresh")
        self._dirty = threading.Event()
        self._subs_lock = threading.Lock()
        # channel -> list of subscriber connections
        self._subscribers: Dict[str, List[ConnectionContext]] = {}
        # node_id -> (rpc address, consecutive failures)
        self._health_lock = threading.Lock()
        self._node_addrs: Dict[NodeID, Tuple[str, int]] = {}
        self._health_fails: Dict[NodeID, int] = {}
        # health-probe clients, owned by the health thread; kept as an
        # attribute (not a loop local) so dead nodes' clients are
        # provably closed and pruned, not leaked
        self._health_clients: Dict[NodeID, RpcClient] = {}
        if restored:
            # Restored nodes are health-checked again: one that died
            # while no GCS ran is then declared dead, not left alive in
            # the tables for every joining driver to dial.
            for info in self.state.get_all_node_info():
                if info.alive and info.rpc_addr is not None:
                    self._node_addrs[info.node_id] = tuple(info.rpc_addr)
                    self._health_fails[info.node_id] = 0
        self._shutdown = threading.Event()

        self.server = RpcServer(host, port, component="gcs")
        self.address = self.server.address
        s = self.server
        s.register("ping", lambda ctx: "pong")
        s.register("register_node", self._register_node)
        s.register("remove_node", self._remove_node)
        s.register("get_all_node_info", lambda ctx: self.state.get_all_node_info())
        s.register("register_actor", lambda ctx, info: self._register_actor(info))
        s.register("update_actor_state",
                   lambda ctx, aid, st, cause: self._update_actor_state(
                       aid, st, cause))
        s.register("update_actor_location",
                   lambda ctx, aid, nid:
                   self.state.update_actor_location(aid, nid))
        s.register("get_actor_info",
                   lambda ctx, aid: self.state.get_actor_info(aid))
        s.register("get_named_actor",
                   lambda ctx, name, ns: self.state.get_named_actor(name, ns))
        s.register("list_actors", lambda ctx: self.state.list_actors())
        s.register("register_gang",
                   lambda ctx, info: self.state.register_gang(info))
        s.register("get_gang_info",
                   lambda ctx, name: self.state.get_gang_info(name))
        s.register("list_gangs", lambda ctx: self.state.list_gangs())
        s.register("update_gang_state",
                   lambda ctx, name, st, cause:
                   self.state.update_gang_state(name, st, cause))
        s.register("unregister_gang",
                   lambda ctx, name: self.state.unregister_gang(name))
        s.register("register_sliceset",
                   lambda ctx, info: self.state.register_sliceset(info))
        s.register("get_sliceset_info",
                   lambda ctx, name: self.state.get_sliceset_info(name))
        s.register("list_slicesets",
                   lambda ctx: self.state.list_slicesets())
        s.register("update_sliceset",
                   lambda ctx, name, st, epoch, restarted, cause:
                   self.state.update_sliceset(name, st, epoch, restarted,
                                              cause))
        s.register("unregister_sliceset",
                   lambda ctx, name: self.state.unregister_sliceset(name))
        s.register("record_checkpoint",
                   lambda ctx, info: self.state.record_checkpoint(info))
        s.register("get_checkpoint",
                   lambda ctx, aid: self.state.get_checkpoint(aid))
        s.register("list_checkpoints",
                   lambda ctx: self.state.list_checkpoints())
        s.register("drop_checkpoint",
                   lambda ctx, aid: self.state.drop_checkpoint(aid))
        s.register("kv_put", lambda ctx, k, v, ns: self.state.kv_put(k, v, ns))
        s.register("kv_get", lambda ctx, k, ns: self.state.kv_get(k, ns))
        s.register("kv_del", lambda ctx, k, ns: self.state.kv_del(k, ns))
        s.register("kv_keys",
                   lambda ctx, p, ns: self.state.kv_keys(p, ns))
        s.register("next_job_id", lambda ctx: self.state.next_job_id())
        s.register("subscribe", self._subscribe)
        s.register("report_resources", self._report_resources)
        self.server.on_disconnect(self._on_disconnect)

        # Local publications (from handler threads) also fan out to wire
        # subscribers.
        self.state.publisher.subscribe("NODE",
                                       lambda m: self._publish("NODE", m))
        self.state.publisher.subscribe("ACTOR",
                                       lambda m: self._publish("ACTOR", m))
        self.state.publisher.subscribe("GANG",
                                       lambda m: self._publish("GANG", m))
        self.state.publisher.subscribe(
            "SLICESET", lambda m: self._publish("SLICESET", m))
        self.state.publisher.subscribe("CKPT",
                                       lambda m: self._publish("CKPT", m))

        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True, name="rtpu-gcs-health")
        self._health_thread.start()
        if self._persist_path:
            # mark-dirty on every mutating handler; a writer thread
            # coalesces snapshots
            for method in ("register_node", "remove_node",
                           "register_actor", "update_actor_state",
                           "update_actor_location",
                           "register_gang", "update_gang_state",
                           "unregister_gang",
                           "register_sliceset", "update_sliceset",
                           "unregister_sliceset",
                           "record_checkpoint", "drop_checkpoint",
                           "kv_put", "kv_del", "next_job_id"):
                self._wrap_dirty(method)
            self._persist_thread = threading.Thread(
                target=self._persist_loop, daemon=True,
                name="rtpu-gcs-persist")
            self._persist_thread.start()

    def rpc_methods(self) -> tuple:
        """Live handler table (rpc-surface introspection hook)."""
        return self.server.registered_methods()

    def _wrap_dirty(self, method: str) -> None:
        fn = self._handlers_get(method)

        def wrapped(ctx, *args, _fn=fn):
            out = _fn(ctx, *args)
            self._dirty.set()
            return out

        self.server.register(method, wrapped)

    def _handlers_get(self, method: str):
        return self.server._handlers[method]

    def _persist_loop(self) -> None:
        while not self._shutdown.wait(0.2):
            if not self._dirty.is_set():
                continue
            self._dirty.clear()
            self._write_snapshot()
        # Final flush: a mutation that landed after the last snapshot
        # but before shutdown must not be silently discarded — the
        # persist_path's whole point is surviving the restart.
        if self._dirty.is_set():
            self._dirty.clear()
            self._write_snapshot()

    def _write_snapshot(self) -> None:
        try:
            # tmp + fsync + rename via the shared durable helper: a
            # crash mid-write must leave the previous snapshot — it is
            # the only copy a restarted GCS can come back from.
            from ray_tpu_torch._private import durable
            durable.atomic_write_bytes(self._persist_path,
                                       self.state.dump_state())
        except Exception:
            logger.exception("gcs persistence write failed")

    # -- handlers ------------------------------------------------------

    def _register_node(self, ctx: ConnectionContext, info: NodeInfo,
                       rpc_addr: Optional[Tuple[str, int]]) -> None:
        if rpc_addr is not None:
            info.rpc_addr = tuple(rpc_addr)
        self.state.register_node(info)
        if rpc_addr is not None:
            with self._health_lock:
                self._node_addrs[info.node_id] = tuple(rpc_addr)
                self._health_fails[info.node_id] = 0

    def _remove_node(self, ctx: ConnectionContext, node_id: NodeID) -> None:
        with self._health_lock:
            self._node_addrs.pop(node_id, None)
            self._health_fails.pop(node_id, None)
        self.state.remove_node(node_id)

    def _register_actor(self, info) -> None:
        self.state.register_actor(info)

    def _update_actor_state(self, actor_id, state, cause) -> None:
        self.state.update_actor_state(actor_id, state, cause)

    def _report_resources(self, ctx: ConnectionContext, node_id: NodeID,
                          available: Dict[str, float],
                          stats: Optional[dict] = None) -> None:
        """Raylet resource report (reference: ray_syncer broadcast);
        relayed to RESOURCES subscribers (the scheduler's view +
        per-node metrics). ``stats`` is the raylet's small metrics
        dict (queue/running/store counters)."""
        self._publish("RESOURCES", (node_id, available, stats))

    def _subscribe(self, ctx: ConnectionContext, channel: str) -> None:
        with self._subs_lock:
            self._subscribers.setdefault(channel, []).append(ctx)

    def _on_disconnect(self, ctx: ConnectionContext) -> None:
        with self._subs_lock:
            for subs in self._subscribers.values():
                if ctx in subs:
                    subs.remove(ctx)

    def _publish(self, channel: str, message) -> None:
        with self._subs_lock:
            subs = list(self._subscribers.get(channel, ()))
        for ctx in subs:
            ctx.push(channel, message)

    # -- health manager ------------------------------------------------

    def _health_loop(self) -> None:
        cfg = get_config()
        period = cfg.health_check_period_ms / 1000.0
        threshold = cfg.health_check_failure_threshold
        clients = self._health_clients
        while not self._shutdown.wait(period):
            with self._health_lock:
                targets = dict(self._node_addrs)
            # Prune clients of removed/declared-dead nodes: an
            # unpruned entry leaks a socket (and its reader thread)
            # per departed node for the lifetime of the GCS.
            for node_id in [n for n in clients if n not in targets]:
                clients.pop(node_id).close()
            for node_id, addr in targets.items():
                ok = False
                try:
                    client = clients.get(node_id)
                    if client is None or not client.alive:
                        # plain client on purpose: health probes must
                        # FAIL on a dead node, not mask it with retries
                        client = RpcClient(addr, connect_timeout=period,
                                           component="gcs_health")
                        clients[node_id] = client
                    client.call("ping", timeout=period * 2)
                    ok = True
                except Exception:
                    ok = False
                declare_dead = False
                with self._health_lock:
                    if node_id not in self._node_addrs:
                        continue
                    if ok:
                        self._health_fails[node_id] = 0
                        continue
                    self._health_fails[node_id] = \
                        self._health_fails.get(node_id, 0) + 1
                    if self._health_fails[node_id] >= threshold:
                        self._node_addrs.pop(node_id, None)
                        self._health_fails.pop(node_id, None)
                        declare_dead = True
                if declare_dead:
                    logger.warning("node %s failed %d health checks; "
                                   "declaring dead", node_id, threshold)
                    dead_client = clients.pop(node_id, None)
                    if dead_client is not None:
                        dead_client.close()
                    self.state.remove_node(node_id)
                    # a death is a mutation: persist it like the RPC ones
                    self._dirty.set()
        for client in clients.values():
            client.close()
        clients.clear()

    def shutdown(self) -> None:
        # Server down FIRST: once _shutdown is set the persist thread
        # may run its final flush at any moment, so no mutating
        # handler may still be acknowledging writes past it.
        self.server.shutdown()
        self._shutdown.set()
        if self._persist_path:
            # The persist thread's exit path flushes any pending dirty
            # state; join it so an embedded GcsServer (tests, and the
            # process entrypoint's finally) never drops the final
            # snapshot on the floor.
            try:
                self._persist_thread.join(timeout=2.0)
            except Exception:
                pass    # never started / already gone


# ---------------------------------------------------------------------------
# process entrypoint


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--port-file", required=True,
                   help="file to write the bound address to")
    p.add_argument("--config", default="",
                   help="serialized system config json")
    p.add_argument("--persist-path", default="",
                   help="snapshot state to this file; reload on start")
    p.add_argument("--port", type=int, default=0,
                   help="bind to this port (0 = ephemeral); a restart "
                        "against the same persist path reuses the old "
                        "port so retrying clients reconnect unchanged")
    args = p.parse_args(argv)
    if args.config:
        get_config().load_serialized(args.config)
    server = GcsServer(port=args.port,
                       persist_path=args.persist_path or None)
    tmp = args.port_file + ".tmp"
    with open(tmp, "w") as f:
        f.write(f"{server.address[0]}:{server.address[1]}")
    os.rename(tmp, args.port_file)
    try:
        # no-deadline: serve-forever parent loop; the process exits on
        # SIGINT/SIGTERM (KeyboardInterrupt) or when the driver reaps it
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()


def spawn_gcs_process(session: str, config_json: str = "",
                      persist: bool = False, port: int = 0
                      ) -> Tuple["subprocess.Popen", Tuple[str, int]]:
    """Start a GCS server as a detached process; returns (proc, addr).
    ``port``: bind there instead of an ephemeral port — restarting a
    killed GCS on its OLD port lets every retrying client (raylets,
    the driver) reconnect without re-discovery."""
    import subprocess
    d = session_dir(session)
    os.makedirs(d, exist_ok=True)
    port_file = os.path.join(d, "gcs.addr")
    if os.path.exists(port_file):
        os.unlink(port_file)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    env["CUDA_VISIBLE_DEVICES"] = ""   # the GCS never touches a card
    # non-durable-ok: append-only child log stream; a torn tail line
    # costs log text, never state
    log = open(os.path.join(d, "gcs.log"), "ab")
    cmd = [sys.executable, "-m", "ray_tpu_torch._private.gcs_server",
           "--port-file", port_file, "--config", config_json]
    if port:
        cmd += ["--port", str(port)]
    if persist:
        cmd += ["--persist-path", os.path.join(d, "gcs_state.bin")]
    proc = subprocess.Popen(cmd, env=env, start_new_session=True,
                            stdout=log, stderr=log)
    log.close()
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline:
        if os.path.exists(port_file):
            host, port = open(port_file).read().strip().rsplit(":", 1)
            return proc, (host, int(port))
        if proc.poll() is not None:
            raise RuntimeError(
                f"gcs server died on startup (rc={proc.returncode})")
        time.sleep(0.02)
    proc.terminate()
    raise TimeoutError("gcs server did not write its address in time")


if __name__ == "__main__":
    main()
