"""GCS client: the GcsLite surface over the wire.

Reference: ``src/ray/gcs/gcs_client/`` accessors [UNVERIFIED — mount
empty, SURVEY.md §0]. Drop-in for ``GcsLite`` (same method surface, so
``Worker`` and libraries cannot tell which they hold) plus a local
``publisher`` fed by server push — subscriptions made on either side
see the same channel stream.

Actor-info reads are cached: task submission consults actor state per
call, and a wire round-trip there would put the GCS on the task hot
path (the reference keeps GCS off it). Pushes on the ACTOR channel
invalidate the cache.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.gcs import (ActorInfo, CheckpointInfo, GangInfo,
                                  NodeInfo, Publisher, SliceSetInfo)
from ray_tpu_torch._private.ids import ActorID, NodeID
from ray_tpu_torch._private.rpc import RetryingRpcClient

logger = logging.getLogger(__name__)


class GcsClient:
    """Survives GCS restarts and severed connections: the channel is a
    ``RetryingRpcClient`` — connection loss reconnects with exponential
    backoff (in the background too, so push subscriptions resume even
    on a call-idle client), re-subscribes the push channels, and
    re-sends the in-flight call under its idempotency token. Against a
    LIVE server (severed/dropped connection) that makes mutations
    exactly-once; across a GCS process crash+restart the dedupe cache
    is gone with the process, so a call executed right before the
    crash may re-execute (at-least-once, like the reference).
    ``on_reconnect`` (when set) runs after every restored connection —
    the raylet re-registers its node there."""

    def __init__(self, address: Tuple[str, int]):
        self.address = tuple(address)
        self.publisher = Publisher()
        self._actor_cache: Dict[ActorID, ActorInfo] = {}
        self._cache_lock = threading.Lock()
        # external re-register hook, fired after a restored connection
        self.on_reconnect: Optional[callable] = None
        self._client = RetryingRpcClient(
            self.address, on_push=self._on_push, component="gcs_client",
            on_reconnect=self._resync, on_restored=self._restored,
            auto_reconnect=True, reconnect_window=None,
            attempt_timeout=5.0)

    def _resync(self, raw) -> None:
        """Connection-scoped state, rebuilt on every (re)connect: the
        push subscriptions live server-side per connection, and any
        cached actor info may be stale across the gap."""
        for channel in ("NODE", "ACTOR", "RESOURCES", "GANG", "SLICESET",
                        "CKPT"):
            raw.call("subscribe", channel, timeout=10.0)
        with self._cache_lock:
            self._actor_cache.clear()

    def _restored(self) -> None:
        cb = self.on_reconnect
        if cb is not None:
            cb()

    @property
    def num_reconnects(self) -> int:
        return self._client.num_reconnects

    def _call(self, method: str, *args, timeout: float = 30.0):
        return self._client.call(method, *args, timeout=timeout)

    def _on_push(self, topic: str, message) -> None:
        if topic == "ACTOR":
            # (state, actor_id): drop the cached info; next read refetches.
            try:
                with self._cache_lock:
                    self._actor_cache.pop(message[1], None)
            except Exception:
                pass    # malformed push: cache entry just lives on
        self.publisher.publish(topic, message)

    # -- jobs ----------------------------------------------------------

    def next_job_id(self) -> int:
        return self._call("next_job_id")

    # -- nodes ---------------------------------------------------------

    def register_node(self, info: NodeInfo,
                      rpc_addr: Optional[Tuple[str, int]] = None) -> None:
        self._call("register_node", info, rpc_addr)

    def remove_node(self, node_id: NodeID) -> None:
        self._call("remove_node", node_id)

    def get_all_node_info(self) -> List[NodeInfo]:
        return self._call("get_all_node_info")

    def report_resources(self, node_id: NodeID,
                         available: Dict[str, float],
                         stats: Optional[dict] = None) -> None:
        self._client.oneway("report_resources", node_id, available,
                            stats)

    # -- actors --------------------------------------------------------

    def register_actor(self, info: ActorInfo) -> None:
        self._call("register_actor", info)
        with self._cache_lock:
            self._actor_cache[info.actor_id] = info

    def update_actor_state(self, actor_id: ActorID, state: str,
                           death_cause: str = "") -> None:
        self._call("update_actor_state", actor_id, state, death_cause)
        with self._cache_lock:
            self._actor_cache.pop(actor_id, None)

    def update_actor_location(self, actor_id: ActorID,
                              node_id) -> None:
        self._call("update_actor_location", actor_id, node_id)
        with self._cache_lock:
            self._actor_cache.pop(actor_id, None)

    def get_actor_info(self, actor_id: ActorID) -> Optional[ActorInfo]:
        with self._cache_lock:
            info = self._actor_cache.get(actor_id)
        if info is not None:
            return info
        info = self._call("get_actor_info", actor_id)
        if info is not None:
            with self._cache_lock:
                self._actor_cache[actor_id] = info
        return info

    def get_named_actor(self, name: str, namespace: str
                        ) -> Optional[ActorInfo]:
        return self._call("get_named_actor", name, namespace)

    def list_actors(self) -> List[ActorInfo]:
        return self._call("list_actors")

    # -- gangs ---------------------------------------------------------
    #
    # Uncached on purpose: gang state is polled on the restart path
    # (member death → re-form), never on the task hot path, and a
    # stale epoch read there would defeat the fence.

    def register_gang(self, info: GangInfo) -> None:
        self._call("register_gang", info)

    def get_gang_info(self, name: str) -> Optional[GangInfo]:
        return self._call("get_gang_info", name)

    def list_gangs(self) -> List[GangInfo]:
        return self._call("list_gangs")

    def update_gang_state(self, name: str, state: str,
                          death_cause: str = "") -> None:
        self._call("update_gang_state", name, state, death_cause)

    def unregister_gang(self, name: str) -> None:
        self._call("unregister_gang", name)

    # -- slice sets ----------------------------------------------------
    #
    # Uncached like the gang table: sliceset state is polled on the
    # slice-recovery path (gang abort → DCN re-join), never on the
    # task hot path, and a stale dcn_epoch read would defeat the fence.

    def register_sliceset(self, info: SliceSetInfo) -> None:
        self._call("register_sliceset", info)

    def get_sliceset_info(self, name: str) -> Optional[SliceSetInfo]:
        return self._call("get_sliceset_info", name)

    def list_slicesets(self) -> List[SliceSetInfo]:
        return self._call("list_slicesets")

    def update_sliceset(self, name: str, state: Optional[str] = None,
                        dcn_epoch: Optional[int] = None,
                        restarted_slice: Optional[int] = None,
                        death_cause: str = "") -> None:
        self._call("update_sliceset", name, state, dcn_epoch,
                   restarted_slice, death_cause)

    def unregister_sliceset(self, name: str) -> None:
        self._call("unregister_sliceset", name)

    # -- actor checkpoints ---------------------------------------------
    #
    # Uncached like the gang table: reads sit on the restore/commit
    # path, never the task hot path, and a stale generation read
    # would defeat the committed-only contract.

    def record_checkpoint(self, info: CheckpointInfo) -> None:
        self._call("record_checkpoint", info)

    def get_checkpoint(self, actor_id: ActorID
                       ) -> Optional[CheckpointInfo]:
        return self._call("get_checkpoint", actor_id)

    def list_checkpoints(self) -> List[CheckpointInfo]:
        return self._call("list_checkpoints")

    def drop_checkpoint(self, actor_id: ActorID) -> None:
        self._call("drop_checkpoint", actor_id)

    # -- internal KV ---------------------------------------------------

    def kv_put(self, key: bytes, value: bytes, namespace: str = "") -> None:
        self._call("kv_put", key, value, namespace)

    def kv_get(self, key: bytes, namespace: str = "") -> Optional[bytes]:
        return self._call("kv_get", key, namespace)

    def kv_del(self, key: bytes, namespace: str = "") -> None:
        self._call("kv_del", key, namespace)

    def kv_keys(self, prefix: bytes, namespace: str = "") -> List[bytes]:
        return self._call("kv_keys", prefix, namespace)

    def close(self) -> None:
        self._client.close()
