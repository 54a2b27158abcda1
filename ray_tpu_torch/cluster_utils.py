"""Cluster test utility: N nodes on one machine.

Reference: ``python/ray/cluster_utils.py`` (``Cluster`` spins up N real
raylets as local processes with fake resources) [UNVERIFIED — mount
empty, SURVEY.md §0]. Two node substrates:

- **logical** (default): a ``Raylet`` object with its own worker pool
  and resource ledger inside the host process — cheap, full actor/PG
  support, used by most tests;
- **remote** (``add_node(remote=True)``): a real raylet *process*
  (``raylet_server.py``) with its own object store, worker pool, and
  wire channels — the distributed plane. Objects cross nodes only via
  chunked transfer; a standalone GCS process health-checks the node.

The scheduler sees both through the same ``ClusterResourceManager``
seam, so the policy layer (including the kernel policy) cannot tell the
difference.

The port's copy of ``ray_tpu/cluster_utils.py``, with ``num_gpus`` for
``num_tpus``. ``Cluster(**kwargs)`` passes ``num_gpus`` on to ``init``
(the head driver owns the cards). A logical node may carry ``GPU``: its
GPU demand runs on the driver's threads. A remote node may not: its
raylet process and workers see no card, so ``GPU`` work there would run
on the CPU, and ``add_node(remote=True, num_gpus>0)`` raises
``ValueError``.
"""

from __future__ import annotations

from typing import Dict, Optional

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.gcs import NodeInfo
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.scheduler.resources import NodeResources
from ray_tpu_torch._private.worker import Worker, global_worker, init, shutdown


def refuse_remote_gpu(resources: Dict[str, float]) -> None:
    """Raise ``ValueError`` for a remote node that would carry GPUs."""
    if resources.get("GPU", 0.0) > 0:
        raise ValueError(
            "a remote node's raylet and workers see no card; GPU work "
            "runs on the head driver's threads (add GPU to the head via "
            "Cluster(num_gpus=...) or to a logical node with "
            "remote=False)")


class Cluster:
    def __init__(self, head_num_cpus: float = 4,
                 head_resources: Optional[Dict[str, float]] = None,
                 start_gcs: bool = False,
                 **kwargs):
        self._worker: Worker = init(num_cpus=head_num_cpus,
                                    resources=head_resources, **kwargs)
        self.head_node_id = self._worker.node_group.head_node_id
        self._gcs_proc = None
        self._gcs_addr = None
        self._gcs_client = None
        self._node_seq = 0
        if start_gcs:
            self._ensure_gcs()

    # -- standalone GCS process ----------------------------------------

    def _ensure_gcs(self):
        if self._gcs_addr is not None:
            return
        if self._worker.gcs_address is not None:
            # gcs_mode=process: the worker already runs a GCS process.
            self._gcs_addr = self._worker.gcs_address
            self._worker.gcs.publisher.subscribe("NODE",
                                                 self._on_node_event)
            return
        from ray_tpu_torch._private.gcs_client import GcsClient
        from ray_tpu_torch._private.gcs_server import spawn_gcs_process
        self._gcs_proc, self._gcs_addr = spawn_gcs_process(
            self._worker.session, get_config().serialize(), persist=True)
        self._gcs_client = GcsClient(self._gcs_addr)
        self._gcs_client.publisher.subscribe("NODE", self._on_node_event)
        # Route raylet heartbeats into the driver (the driver's own gcs
        # is in-proc here; this client is its channel to the GCS proc).
        self._gcs_client.publisher.subscribe(
            "RESOURCES", self._worker._on_resource_report)

    @property
    def gcs_address(self):
        return self._gcs_addr

    @property
    def gcs_client(self):
        return self._gcs_client

    def _on_node_event(self, msg) -> None:
        """GCS health manager declared a node dead: tear it down."""
        kind, payload = msg
        if kind == "REMOVED":
            self._worker.node_group._on_remote_node_lost(payload)

    # -- membership ----------------------------------------------------

    def add_node(self, num_cpus: float = 4, num_gpus: float = 0,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 max_process_workers: int = 2,
                 remote: bool = False,
                 object_store_memory: int = 0) -> NodeID:
        total = {"CPU": float(num_cpus)}
        if num_gpus:
            total["GPU"] = float(num_gpus)
        if resources:
            total.update({k: float(v) for k, v in resources.items()})
        if remote:
            refuse_remote_gpu(total)
        w = self._worker
        node_id = NodeID.from_random()
        if remote:
            self._ensure_gcs()
            from ray_tpu_torch._private.raylet_server import spawn_raylet_process
            self._node_seq += 1
            node_session = f"{w.session}n{self._node_seq}"
            proc, addr = spawn_raylet_process(
                node_session, node_id, total, gcs_addr=self._gcs_addr,
                max_process_workers=max_process_workers, labels=labels,
                object_store_memory=object_store_memory)
            w.node_group.add_remote_node(
                node_id, addr,
                NodeResources(total=dict(total), available=dict(total),
                              labels=dict(labels or {})),
                proc=proc)
        else:
            raylet = w.node_group.add_node(
                node_id, NodeResources(total=dict(total),
                                       available=dict(total)),
                labels=labels)
            raylet.worker_pool._max_process = max_process_workers
        w.gcs.register_node(NodeInfo(node_id=node_id,
                                     resources_total=dict(total),
                                     labels=labels or {}))
        w.node_group.recheck_infeasible()
        return node_id

    def remove_node(self, node_id: NodeID) -> None:
        ng = self._worker.node_group
        if node_id in ng._remote_nodes:
            ng.remove_remote_node(node_id)
        else:
            ng.remove_node(node_id)
        self._worker.gcs.remove_node(node_id)

    def kill_raylet_process(self, node_id: NodeID) -> None:
        """Hard-kill a remote raylet process (fault injection). Driver
        notices via the broken channel / GCS health check."""
        handle = self._worker.node_group._remote_nodes.get(node_id)
        if handle is not None and handle.proc is not None:
            handle.proc.kill()

    @property
    def worker(self) -> Worker:
        return self._worker

    def shutdown(self) -> None:
        if self._gcs_client is not None:
            self._gcs_client.close()
            self._gcs_client = None
        shutdown()
        if self._gcs_proc is not None:
            try:
                self._gcs_proc.terminate()
                self._gcs_proc.wait(timeout=5)
            except Exception:
                pass    # GCS process already exited
            self._gcs_proc = None
            self._gcs_addr = None
