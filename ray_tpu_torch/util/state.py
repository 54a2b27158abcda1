"""State API: programmatic cluster introspection.

Reference: ``python/ray/util/state/`` (``ray list tasks/actors/objects/
nodes/workers``, ``ray summary``) [UNVERIFIED — mount empty, SURVEY.md
§0]. Driver-side views over the GCS tables, the task manager, the
reference counter, and the object stores; each ``list_*`` returns
plain dicts (the CLI renders them).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch._private.worker import global_worker


def list_nodes() -> List[dict]:
    w = global_worker()
    out = []
    cluster = {nid: res for nid, res in
               w.node_group.cluster_resources.nodes()}
    for info in w.gcs.get_all_node_info():
        res = cluster.get(info.node_id)
        stats = w.node_stats.get(info.node_id)
        stats_d = dict(stats[1]) if stats else {}
        is_head = info.node_id == w.node_group.head_node_id
        if is_head and not stats_d:
            # the head has no heartbeat-to-self: fill its worker RSS
            # live so the nodes table shows per-worker memory for
            # every node (reporter-agent role)
            from ray_tpu_torch._private.profiling import worker_rss_map
            raylet = w.node_group._raylets.get(info.node_id)
            if raylet is not None:
                rss = worker_rss_map(raylet.worker_pool)
                stats_d = {"worker_rss": rss,
                           "workers_rss_bytes": sum(rss.values())}
        out.append({
            "node_id": info.node_id.hex(),
            "alive": info.alive,
            "resources_total": dict(info.resources_total),
            "resources_available": dict(res.available) if res else {},
            "labels": dict(info.labels),
            "is_head": is_head,
            "remote": info.node_id in w.node_group._remote_nodes,
            # latest heartbeat stats from the node's raylet (per-node
            # agent plane), incl. per-worker RSS
            "stats": stats_d,
        })
    return out


def list_actors(state: Optional[str] = None) -> List[dict]:
    w = global_worker()
    out = []
    for info in w.gcs.list_actors():
        if state is not None and info.state != state:
            continue
        out.append({
            "actor_id": info.actor_id.hex(),
            "class_name": info.class_name,
            "state": info.state,
            "name": info.name,
            "namespace": info.namespace,
            "num_restarts": info.num_restarts,
            "death_cause": info.death_cause,
        })
    return out


def list_tasks(status: Optional[str] = None) -> List[dict]:
    """Latest known state per task. Live records come from the task
    manager; completed tasks whose lineage was already released come
    from the task-event ring buffer (the reference keeps this split
    too: lineage is GC'd, GcsTaskManager's event log is what `ray list
    tasks` reads)."""
    from ray_tpu_torch._private import events

    w = global_worker()
    rows: Dict[str, dict] = {}
    for e in events.raw_events():
        state_name = {"RUNNING": "running", "FINISHED": "finished",
                      "FAILED": "failed"}.get(e["state"], e["state"])
        rows[e["task_id"]] = {
            "task_id": e["task_id"],
            "name": e["name"],
            "status": state_name,
            "attempt": None,
            "retries_left": None,
            "resources": {},
        }
    for rec in w.task_manager.list_records():
        rows[rec.spec.task_id.hex()] = {
            "task_id": rec.spec.task_id.hex(),
            "name": rec.spec.repr_name(),
            "status": rec.status,
            "attempt": rec.attempt,
            "retries_left": rec.retries_left,
            "resources": dict(rec.spec.resources),
        }
    out = list(rows.values())
    if status is not None:
        out = [r for r in out if r["status"] == status]
    return out


def list_objects() -> List[dict]:
    w = global_worker()
    out = []
    for oid, counts in w.reference_counter.snapshot().items():
        if w.device_store.contains(oid):
            where = "device"
        elif w.shm_store.contains(oid):
            where = "shm"
        elif w.memory_store.contains(oid):
            entry = w.memory_store.get(oid, timeout=0)
            where = {"blob": "inline", "err": "error",
                     "remote": "remote"}.get(entry.kind, entry.kind)
        else:
            where = "pending"
        out.append({
            "object_id": oid.hex(),
            "reference_counts": counts,
            "location": where,
        })
    return out


def list_workers() -> List[dict]:
    w = global_worker()
    out = []
    with w.node_group._lock:
        raylets = dict(w.node_group._raylets)
    for nid, raylet in raylets.items():
        stats = raylet.worker_pool.stats()
        out.append({
            "node_id": nid.hex(),
            "kind": "logical",
            **stats,
        })
    with w.node_group._lock:
        remotes = dict(w.node_group._remote_nodes)
    for nid, handle in remotes.items():
        try:
            stats = handle.client.call("stats", timeout=5)
            out.append({"node_id": nid.hex(), "kind": "raylet_process",
                        **stats.get("workers", {})})
        except Exception:
            out.append({"node_id": nid.hex(), "kind": "raylet_process",
                        "unreachable": True})
    return out


def summary() -> dict:
    w = global_worker()
    tm = w.task_manager.stats()
    return {
        "nodes": len(list_nodes()),
        "actors": {
            st: sum(1 for a in list_actors() if a["state"] == st)
            for st in ("PENDING", "ALIVE", "RESTARTING", "DEAD")
        },
        "tasks": tm,
        "objects": w.shm_store.stats(),
        "device_objects": w.device_store.stats(),
        # authoritative ref total — list endpoints cap at 500 rows, so
        # consumers (ray_tpu_torch memory) report THIS, not a list length
        "live_refs": len(w.reference_counter.snapshot()),
        "scheduler": w.node_group.stats(),
    }
