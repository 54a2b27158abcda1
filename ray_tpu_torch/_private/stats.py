"""Built-in runtime metrics.

Reference: ``src/ray/stats/metric_defs.cc`` (``ray_tasks{State=...}``,
``ray_object_store_memory``, scheduler gauges) exported through the
per-node metrics agent [UNVERIFIED — mount empty, SURVEY.md §0].
System series register in the same registry as user metrics
(``ray_tpu_torch.util.metrics``) and refresh at scrape time from the live
runtime, so one /metrics endpoint covers both.
"""

from __future__ import annotations

from ray_tpu_torch.util import metrics as m

_installed = False


def install_runtime_metrics() -> None:
    """Idempotent; safe across init/shutdown cycles (the collector
    no-ops when no runtime is live)."""
    global _installed
    if _installed:
        return
    _installed = True

    tasks = m.Gauge("ray_tpu_tasks", "Task counts by state",
                    tag_keys=("state",))
    objects = m.Gauge("ray_tpu_object_store_bytes",
                      "Shared-memory store usage", tag_keys=("kind",))
    hbm = m.Gauge("ray_tpu_device_object_bytes",
                  "HBM-resident object bytes")
    sched = m.Gauge("ray_tpu_scheduler", "Scheduler queue sizes",
                    tag_keys=("queue",))
    nodes = m.Gauge("ray_tpu_nodes", "Cluster nodes by liveness",
                    tag_keys=("state",))
    actors = m.Gauge("ray_tpu_actors", "Actors by state",
                     tag_keys=("state",))
    oom_kills = m.Gauge(
        "ray_tpu_oom_kills",
        "Tasks killed by the node memory watchdog (owner view)")
    inflight = m.Gauge(
        "ray_tpu_inflight_window",
        "Owner->raylet in-flight lease window usage", tag_keys=("node",))
    gang_aborts = m.Gauge(
        "ray_tpu_gang_aborts",
        "Collective-gang aborts observed by this driver (member death "
        "or kill fencing off an incarnation)")
    gang_restarts = m.Gauge(
        "ray_tpu_gang_restarts",
        "Coordinated gang restarts started by this driver")
    gang_epoch = m.Gauge(
        "ray_tpu_gang_epoch",
        "Current incarnation epoch per collective gang",
        tag_keys=("group",))
    dcn_bytes = m.Gauge(
        "ray_tpu_dcn_bytes",
        "Bytes injected into the simulated cross-slice DCN tier "
        "(sum of leader rank-file writes across every sliceset; the "
        "hierarchical allreduce keeps this at ~1/num_slices of what a "
        "flat allreduce would move)")
    dcn_ms = m.Gauge(
        "ray_tpu_dcn_collective_ms",
        "Cumulative wall-clock inside DCN-tier collectives (cost "
        "model included), summed across slice leaders")
    slice_restarts = m.Gauge(
        "ray_tpu_slice_restarts",
        "Coordinated whole-slice gang restarts per slice index "
        "(summed across slicesets)", tag_keys=("slice",))
    checkpoints = m.Gauge(
        "ray_tpu_checkpoints",
        "Actor checkpoint plane: committed generations (saved), "
        "successful restore-at-creation events (restored), and "
        "torn/uncommitted/partial generations dropped (discarded)",
        tag_keys=("state",))
    ckpt_bytes = m.Gauge(
        "ray_tpu_checkpoint_bytes",
        "Cumulative payload bytes across committed actor checkpoints")
    restore_ms = m.Gauge(
        "ray_tpu_restore_ms",
        "Duration of the most recent successful checkpoint restore")
    rpc_batch = m.Gauge(
        "ray_tpu_rpc_batch_size",
        "Realized payloads-per-frame coalescing factor per wire "
        "channel (docs/data_plane.md): driver-local channels plus "
        "the per-raylet channels reported in heartbeats, summed "
        "across nodes", tag_keys=("channel",))
    rpc_fastframe = m.Gauge(
        "ray_tpu_rpc_fastframe_hits",
        "Frames shipped on the negotiated binary small-frame fast "
        "path (all channels, driver + heartbeat-reported)")
    rpc_dedupe_rate = m.Gauge(
        "ray_tpu_rpc_dedupe_hit_rate",
        "Idempotency dedupe-cache hit rate across raylet rpc "
        "servers (heartbeat-reported; >0 means retries/duplicate "
        "frames were collapsed)")
    object_pulls = m.Gauge(
        "ray_tpu_object_pulls",
        "Pull-plane transfers by outcome across the cluster "
        "(docs/object_plane.md): started (wire fetches driven), "
        "deduped (readers attached to an in-flight fetch), rerouted "
        "(source failover / owner re-route), striped (multi-source "
        "range fan-in), failed (typed terminal errors)",
        tag_keys=("state",))
    serve_rps = m.Gauge(
        "ray_tpu_serve_rps",
        "Serve-plane requests/s accepted by this process's routers "
        "over the last scrape window (docs/serve.md)")
    serve_queue = m.Gauge(
        "ray_tpu_serve_queue_depth",
        "Per-deployment total request queue in the driver's router: "
        "batch-parked + in-flight + admission waiters; returns to 0 "
        "when load stops", tag_keys=("deployment",))
    serve_batch = m.Gauge(
        "ray_tpu_serve_batch_size",
        "Realized requests-per-dispatch on the serve batched path "
        "(cumulative average)")
    serve_replicas = m.Gauge(
        "ray_tpu_serve_replicas",
        "Live replicas per deployment (autoscaler-visible)",
        tag_keys=("deployment",))
    serve_first_token = m.Gauge(
        "ray_tpu_serve_first_token_ms",
        "Streaming serve requests: mean time from request parse to "
        "the first item on the wire, over the recent sample window "
        "(docs/serve.md §Ingress; 0 = no streamed load)")
    data_queued = m.Gauge(
        "ray_tpu_data_queued_bytes",
        "Streaming data plane: bytes parked at each live pipeline "
        "stage (queued + in-flight inputs + completed-unconsumed "
        "outputs; docs/data_pipeline.md). Bounded by the per-stage "
        "budget; series vanish when the pipeline completes",
        tag_keys=("stage",))
    data_blocks = m.Gauge(
        "ray_tpu_data_blocks",
        "Streaming data plane: cumulative block counts — produced "
        "(read/map outputs), consumed (handed to the consumer), "
        "reconstructed (re-driven after a map-worker death)",
        tag_keys=("state",))
    data_bp = m.Gauge(
        "ray_tpu_data_backpressure_events",
        "Map/read launches deferred because a downstream stage sat "
        "at its byte budget (typed BackpressureError signals)")
    data_zero_copy = m.Gauge(
        "ray_tpu_data_zero_copy_blocks",
        "Blocks handed downstream on the shm/fastframe zero-copy "
        "path (stored over the inline threshold; consumers mmap "
        "instead of re-pickling)")
    data_locality = m.Gauge(
        "ray_tpu_data_locality",
        "Actor-pool block routing decisions: hits dispatched to a "
        "worker co-located with the block's bytes, misses crossed "
        "nodes", tag_keys=("kind",))
    data_starvation = m.Gauge(
        "ray_tpu_data_trainer_starvation",
        "Fraction of the last run_with_data wall time the trainer "
        "spent waiting on the data iterator (~0 = compute-bound)")
    as_instances = m.Gauge(
        "ray_tpu_autoscaler_instances",
        "Cluster-autoscaler instance table by lifecycle state "
        "(docs/autoscaler.md); series vanish when a scaler stops",
        tag_keys=("state",))
    as_demand = m.Gauge(
        "ray_tpu_autoscaler_demand",
        "Aggregated pending demand per resource shape (gang "
        "granular, e.g. shape=\"CPU:1,GPU:8\"); returns to 0 when "
        "the unplaceable ledger and PG cohorts drain",
        tag_keys=("shape",))
    as_retries = m.Gauge(
        "ray_tpu_autoscaler_launch_retries",
        "Cumulative instance re-launches beyond the first attempt "
        "(lost/failed/boot-then-die allocations re-driven under "
        "seeded backoff)")
    as_drains = m.Gauge(
        "ray_tpu_autoscaler_drains",
        "Completed drain-before-terminate scale-downs (cordon + "
        "checkpoint + migrate succeeded before the node left)")

    def collect():
        from ray_tpu_torch._private.worker import try_global_worker
        w = try_global_worker()
        if w is None:
            return
        tm = w.task_manager.stats()
        for state in ("pending", "finished", "failed", "retries"):
            tasks.set(tm.get(state, 0), tags={"state": state})
        ng_stats = w.node_group.stats()
        # overload plane: cumulative sheds honored, plus the live
        # count of backpressured (deferred) tasks — the latter returns
        # to zero once the overload clears. Serve-plane sheds fold
        # into the same family (docs/serve.md §Backpressure).
        from ray_tpu_torch._private import serve_stats
        serve_counts = serve_stats.snapshot()
        tasks.set(ng_stats.get("shed", 0) + serve_counts.get("shed", 0),
                  tags={"state": "shed"})
        tasks.set(ng_stats.get("deferred", 0),
                  tags={"state": "backpressured"})
        # placement plane (docs/scheduler.md): live count of tasks the
        # cluster cannot currently hold — parked totals-infeasible plus
        # the capacity-fenced unplaceable ledger; returns to zero when
        # capacity appears and the classes drain
        tasks.set(ng_stats.get("infeasible", 0)
                  + ng_stats.get("unplaceable", 0),
                  tags={"state": "infeasible"})
        oom_kills.set(tm.get("oom_kills", 0))
        inflight.clear()
        for node_hex, count in w.node_group.inflight_windows().items():
            inflight.set(count, tags={"node": node_hex})
        store = w.shm_store.stats()
        objects.set(store["used_bytes"], tags={"kind": "used"})
        objects.set(store["capacity_bytes"], tags={"kind": "capacity"})
        hbm.set(w.device_store.stats()["hbm_bytes"])
        for queue in ("to_schedule", "waiting_deps", "running",
                      "infeasible", "unplaceable", "deferred"):
            sched.set(ng_stats.get(queue, 0), tags={"queue": queue})
        infos = w.gcs.get_all_node_info()
        nodes.set(sum(1 for i in infos if i.alive), tags={"state": "alive"})
        nodes.set(sum(1 for i in infos if not i.alive),
                  tags={"state": "dead"})
        by_state: dict = {}
        for info in w.gcs.list_actors():
            by_state[info.state] = by_state.get(info.state, 0) + 1
        for state, count in by_state.items():
            actors.set(count, tags={"state": state})
        gang_aborts.set(getattr(w, "num_gang_aborts", 0))
        gang_restarts.set(getattr(w, "num_gang_restarts", 0))
        gang_epoch.clear()   # destroyed gangs' series must vanish
        for g in w.gcs.list_gangs():
            gang_epoch.set(g.epoch, tags={"group": g.name})
        dcn_bytes.set(getattr(w, "dcn_bytes_total", 0))
        dcn_ms.set(getattr(w, "dcn_collective_ms_total", 0.0))
        slice_restarts.clear()   # destroyed slicesets' series vanish
        per_slice: dict = {}
        for ss in w.gcs.list_slicesets():
            for idx, count in enumerate(ss.slice_restarts):
                per_slice[idx] = per_slice.get(idx, 0) + count
        for idx, count in per_slice.items():
            slice_restarts.set(count, tags={"slice": str(idx)})
        checkpoints.set(getattr(w, "num_ckpt_saved", 0),
                        tags={"state": "saved"})
        checkpoints.set(getattr(w, "num_ckpt_restored", 0),
                        tags={"state": "restored"})
        checkpoints.set(getattr(w, "num_ckpt_discarded", 0),
                        tags={"state": "discarded"})
        ckpt_bytes.set(getattr(w, "ckpt_bytes_total", 0))
        restore_ms.set(getattr(w, "last_restore_ms", 0.0))
        # Wire-plane gauges (docs/data_plane.md): merge this process's
        # channel counters with each live raylet's heartbeat-reported
        # "wire" sub-dict (same channel name sums across nodes).
        from ray_tpu_torch._private import wire_stats
        merged: dict = {name: dict(snap)
                        for name, snap in wire_stats.snapshot().items()}
        from ray_tpu_torch._private import object_transfer
        pulls = dict(object_transfer.pull_counters())  # driver's engine
        dedupe_hits = dedupe_calls = 0
        for _nid, (_ts, nstats) in list(w.node_stats.items()):
            dedupe_hits += nstats.get("dedupe_hits", 0)
            dedupe_calls += nstats.get("dedupe_calls", 0)
            for state, count in (nstats.get("pulls") or {}).items():
                pulls[state] = pulls.get(state, 0) + count
            wire = nstats.get("wire")
            if not isinstance(wire, dict):
                continue
            for name, snap in wire.items():
                agg = merged.setdefault(
                    name, {"frames": 0, "payloads": 0, "bytes": 0,
                           "fastframe_hits": 0})
                for k in ("frames", "payloads", "bytes",
                          "fastframe_hits"):
                    agg[k] = agg.get(k, 0) + snap.get(k, 0)
        rpc_batch.clear()   # stopped-beating nodes' channels vanish
        fastframe_hits = 0
        for name, snap in merged.items():
            frames = snap.get("frames", 0)
            if frames:
                rpc_batch.set(snap.get("payloads", 0) / frames,
                              tags={"channel": name})
            fastframe_hits += snap.get("fastframe_hits", 0)
        rpc_fastframe.set(fastframe_hits)
        rpc_dedupe_rate.set(dedupe_hits / dedupe_calls
                            if dedupe_calls else 0.0)
        for state, count in pulls.items():
            object_pulls.set(count, tags={"state": state})
        # serve plane (docs/serve.md §Observability): RPS over the
        # scrape window, live queue depth + replica count per
        # deployment, realized batch coalescing factor
        serve_rps.set(serve_stats.rps_sample())
        serve_batch.set(serve_stats.batch_avg())
        serve_first_token.set(serve_stats.first_token_ms())
        serve_queue.clear()      # deleted deployments' series vanish
        serve_replicas.clear()
        for controller in serve_stats.controllers():
            try:
                for name, qd, nrep in controller.metrics_snapshot():
                    serve_queue.set(qd, tags={"deployment": name})
                    serve_replicas.set(nrep, tags={"deployment": name})
            except Exception:  # noqa: BLE001
                # controller mid-shutdown: skip its series this scrape
                pass
        # streaming data plane (docs/data_pipeline.md §Observability):
        # per-stage queued bytes come from live executors only — the
        # clear()+re-set makes completed pipelines' series vanish, so
        # every gauge returns to baseline once a run finishes.
        from ray_tpu_torch._private import data_stats
        data_queued.clear()
        for stage, nbytes in data_stats.queued_bytes_by_stage().items():
            data_queued.set(nbytes, tags={"stage": stage})
        dsnap = data_stats.snapshot()
        for state in ("produced", "consumed", "reconstructed"):
            data_blocks.set(dsnap.get("blocks_" + state, 0),
                            tags={"state": state})
        data_bp.set(dsnap.get("backpressure_events", 0))
        data_zero_copy.set(dsnap.get("zero_copy_blocks", 0))
        data_locality.set(dsnap.get("locality_hits", 0),
                          tags={"kind": "hits"})
        data_locality.set(dsnap.get("locality_misses", 0),
                          tags={"kind": "misses"})
        data_starvation.set(data_stats.starvation())
        # cluster autoscaler (docs/autoscaler.md §Observability): the
        # clear()+re-set idiom makes a stopped scaler's per-state and
        # per-shape series vanish
        from ray_tpu_torch.autoscaler import v2 as autoscaler_v2
        asnap = autoscaler_v2.metrics_snapshot()
        as_instances.clear()
        for state, count in asnap["instances"].items():
            as_instances.set(count, tags={"state": state})
        as_demand.clear()
        for shape, count in asnap["demand"].items():
            as_demand.set(count, tags={"shape": shape})
        as_retries.set(asnap["launch_retries"])
        as_drains.set(asnap["drains"])

    m.register_collector(collect)


def node_reporter_gauges():
    """The per-node reporter-agent series (resource ledger totals/
    availability, raylet heartbeat stats, per-worker RSS). Declared
    here — not at the collector in worker.py — so every ``ray_tpu_*``
    constructor lives in a stats module, where the metric-discipline
    pass audits names, label keys, and the docs registry. The caller
    (``Worker._install_node_metrics``) owns the refresh collector.

    Returns ``(available, total, stat, rss)`` gauges.
    """
    avail_g = m.Gauge(
        "ray_tpu_node_resource_available",
        "Per-node available resource units",
        tag_keys=("node", "resource"))
    total_g = m.Gauge(
        "ray_tpu_node_resource_total",
        "Per-node total resource units",
        tag_keys=("node", "resource"))
    stat_g = m.Gauge(
        "ray_tpu_node_stat",
        "Per-node raylet stats (queued/running tasks, actors, "
        "store bytes/objects, workers, pulls)",
        tag_keys=("node", "stat"))
    rss_g = m.Gauge(
        "ray_tpu_worker_rss_bytes",
        "Per-worker resident set size (reporter-agent role)",
        tag_keys=("node", "worker"))
    return avail_g, total_g, stat_g, rss_g
