"""Two-tier config system.

The port's own copy of ``ray_tpu/_private/config.py``: every key, with
the same names, types, defaults and ``RAY_TPU_`` environment prefix.

Mirrors the reference's ``RAY_CONFIG(type, name, default)`` macro table
(royf/ray ``src/ray/common/ray_config_def.h`` [UNVERIFIED — mount empty,
SURVEY.md §0]): a flat registry of typed knobs, each overridable via a
``RAY_TPU_<name>`` environment variable per-process and via the
``_system_config`` dict passed to ``ray_tpu_torch.init`` cluster-wide.

Python library-layer configs (ScalingConfig, DataContext, ...) live with
their libraries; this module is the runtime-core tier only.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Any, Callable, Dict

_ENV_PREFIX = "RAY_TPU_"


def _apply_log_level(values: Dict[str, Any]) -> None:
    level = values.get("log_level")
    if level:
        try:
            logging.getLogger("ray_tpu_torch").setLevel(level.upper())
        except ValueError:
            logging.getLogger(__name__).warning(
                "invalid log_level %r; keeping current level", level)


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


_PARSERS: Dict[type, Callable[[str], Any]] = {
    bool: _parse_bool,
    int: int,
    float: float,
    str: str,
}


class Config:
    """Singleton runtime config. Access knobs as attributes."""

    _DEFS: Dict[str, tuple] = {}  # name -> (type, default, doc)

    def __init__(self):
        self._values: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._load_env()
        _apply_log_level(self._values)

    @classmethod
    def define(cls, name: str, typ: type, default: Any, doc: str = ""):
        cls._DEFS[name] = (typ, default, doc)

    def _load_env(self):
        for name, (typ, default, _doc) in self._DEFS.items():
            env = os.environ.get(_ENV_PREFIX + name)
            if env is not None:
                self._values[name] = _PARSERS[typ](env)
            else:
                self._values[name] = default

    def apply_system_config(self, system_config: Dict[str, Any]):
        """Cluster-wide overrides (the ``_system_config`` JSON of the
        reference). Env vars still win: they were applied per-process."""
        with self._lock:
            for name, value in system_config.items():
                if name not in self._DEFS:
                    raise ValueError(f"Unknown system config key: {name}")
                if _ENV_PREFIX + name in os.environ:
                    continue
                typ = self._DEFS[name][0]
                if isinstance(value, str) and typ is not str:
                    value = _PARSERS[typ](value)
                self._values[name] = typ(value)
            _apply_log_level(self._values)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._values)

    def restore(self, values: Dict[str, Any]) -> None:
        """Put back a ``snapshot()``: a runtime's ``_system_config``
        lives as long as that runtime, not past its ``shutdown()``."""
        with self._lock:
            self._values = dict(values)
            _apply_log_level(self._values)

    def serialize(self) -> str:
        return json.dumps(self._values)

    def load_serialized(self, payload: str):
        with self._lock:
            self._values.update(json.loads(payload))
            _apply_log_level(self._values)

    def __getattr__(self, name: str) -> Any:
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(name) from None

    def reset(self):
        with self._lock:
            self._values.clear()
            self._load_env()
            _apply_log_level(self._values)


_D = Config.define

# --- scheduling (reference: scheduler_* knobs) ---
_D("scheduler_spread_threshold", float, 0.5,
   "Critical-resource utilization above which the hybrid policy stops "
   "packing onto the local node and spreads by least-utilization.")
_D("scheduler_top_k_fraction", float, 0.2,
   "Fraction of feasible nodes considered in the top-k tie-break.")
_D("scheduler_top_k_absolute", int, 1,
   "Minimum top-k regardless of fraction.")
_D("tpu_scheduler_batch_size", int, 512,
   "Pending tasks batched per TPU scheduling-kernel invocation.")
_D("tpu_scheduler_min_batch", int, 64,
   "Pending-queue depth below which the adaptive policy uses the CPU "
   "scan (no device round-trip floor) instead of the kernel.")
_D("pg_kernel_min_work", int, 4096,
   "bundles x nodes product above which placement-group packing uses "
   "the jitted assignment kernel (accelerator hosts only).")
_D("pg_pack_topk", int, 128,
   "Candidate nodes per group in the batched gang-packing kernel's "
   "top-k pre-filter (raised to the group's bundle count, capped at "
   "the cluster size). Groups that don't fit their candidate set "
   "fall back to the full single-group solve.")
_D("scheduler_fence_enabled", bool, True,
   "Park capacity-fenced scheduling classes (batch count beyond the "
   "node-totals capacity bound) in the owner's unplaceable ledger, "
   "released on the next cluster resource-version delta, instead of "
   "rescanning them every tick. Off = legacy retry-every-tick.")
_D("use_tpu_scheduler", str, "auto",
   "Select the kernel policy in the ISchedulingPolicy registry: "
   "'auto' (default) uses it on a CUDA device and the CPU hybrid on "
   "the CPU, '1'/'true' forces it, '0'/'false' forces the CPU hybrid.")

# --- core worker / tasks ---
_D("task_max_retries", int, 3, "Default retries for normal tasks.")
_D("actor_max_restarts", int, 0, "Default actor restart count.")
_D("max_direct_call_object_size", int, 100 * 1024,
   "Results at or below this size are inlined in the reply instead of "
   "going through the shared-memory store.")
_D("worker_lease_timeout_ms", int, 30000,
   "Timeout for a lease/submit RPC to a remote raylet.")
_D("task_events_max_buffer", int, 100000,
   "Ring-buffer capacity of the per-worker task event stream.")

# --- object store ---
_D("object_store_memory_bytes", int, 512 * 1024 * 1024,
   "Per-node shared-memory store capacity.")
_D("object_spilling_threshold", float, 0.8,
   "Fraction of store capacity above which primary copies spill to disk.")
_D("object_store_fallback_directory", str, "",
   "Spill directory; empty = <session_dir>/spill.")
_D("object_chunk_size_bytes", int, 5 * 1024 * 1024,
   "Chunk size for node-to-node object transfer.")
_D("object_pull_deadline_s", float, 60.0,
   "Total per-object pull budget: every chunk call, retry, backoff "
   "sleep, and source re-route for one pull fits inside this window.")
_D("object_pull_chunk_timeout_s", float, 10.0,
   "Per-chunk RPC timeout inside a pull (clamped to the remaining "
   "pull deadline).")
_D("object_pull_retry_base_s", float, 0.05,
   "Base delay of the pull retry backoff (exponential, seeded-jitter "
   "via _private/backoff.py).")
_D("object_pull_retry_cap_s", float, 2.0,
   "Cap of the pull retry backoff.")
_D("object_pull_max_inflight_bytes", int, 256 * 1024 * 1024,
   "Per-process admission budget for concurrent in-flight pull "
   "buffers: a restart storm of pulls queues here instead of "
   "OOM-killing the node (oversized single objects admit alone).")
_D("object_stripe_min_bytes", int, 32 * 1024 * 1024,
   "Objects at or above this size stripe chunk ranges across all "
   "sealed holders instead of pulling from one source.")
_D("object_stripe_max_sources", int, 4,
   "Maximum concurrent sources a striped pull fans in from.")
_D("object_locality_min_bytes", int, 1024 * 1024,
   "Scheduler locality hint threshold: tasks whose remote-located "
   "args total at least this many bytes prefer the node holding "
   "them (docs/object_plane.md).")

# --- worker pool ---
_D("worker_pool_prestart", int, 0, "Workers to pre-fork at init.")
_D("worker_pool_max_idle_s", float, 60.0, "Idle worker reap time.")
_D("worker_start_timeout_s", float, 60.0, "Worker process start timeout.")

# --- rpc transport hardening (reference: grpc client retry knobs) ---
_D("rpc_reconnect_backoff_base_ms", int, 50,
   "Initial delay between reconnect attempts of a retrying RPC "
   "client; doubles per attempt (with jitter).")
_D("rpc_reconnect_backoff_max_ms", int, 2000,
   "Reconnect backoff ceiling.")
_D("rpc_call_deadline_ms", int, 30000,
   "Default overall deadline of one logical call on a retrying RPC "
   "client, spanning reconnects and idempotent re-sends.")
_D("rpc_dedupe_cache_size", int, 4096,
   "Server-side idempotency-token dedupe cache entries (LRU): a "
   "retried call whose token is cached replays the recorded reply "
   "instead of re-executing the handler.")
_D("raylet_channel_reconnect_ms", int, 3000,
   "How long the owner's channel to a raylet keeps trying to "
   "reconnect after a connection loss before the node is declared "
   "lost (its tasks then retry on survivors).")

# --- data-plane fast path (batched submits/completions + binary
# small frames; see docs/data_plane.md) ---
_D("submit_coalesce_ms", float, 2.0,
   "Adaptive flush window of the owner's scheduling loop: while the "
   "submission stream is bursting (the previous tick placed a real "
   "batch — at least 4 tasks), the loop waits up to this long for "
   "more submits before scheduling, so per-tick sendables leave as "
   "one batch (one submit_many frame per raylet, one exec_batch "
   "frame per worker) instead of a frame per task. A quiet stream "
   "(serial round trips) never waits. <= 0 disables the window.")
_D("submit_coalesce_max", int, 512,
   "Batch-size target of the submit coalescing window: a tick stops "
   "gathering once this many tasks are queued for scheduling.")
_D("task_done_coalesce_ms", float, 2.0,
   "Raylet-side completion coalescing window: task_done pushes to "
   "one owner channel buffer up to this long (or up to "
   "task_done_coalesce_max payloads) and leave as one "
   "task_done_many frame. The first push after an idle window "
   "bypasses the buffer, so serial round trips pay nothing. "
   "<= 0 disables coalescing (every push ships alone).")
_D("task_done_coalesce_max", int, 64,
   "Max task_done payloads per coalesced task_done_many frame.")
_D("worker_reply_flush_ms", float, 1.5,
   "Worker-side completion coalescing: 'done' replies buffer until "
   "the worker's intake is idle, this deadline passes, or "
   "worker_reply_flush_max replies accumulate — then ship as one "
   "('batch', ...) frame. <= 0 sends every reply alone.")
_D("worker_reply_flush_max", int, 64,
   "Max replies per coalesced worker ('batch', ...) frame.")
_D("fastframe_threshold_bytes", int, 16384,
   "RPC frames whose msgpack-safe body encodes at or below this size "
   "ride the binary small-frame fast path (no outer pickle) when "
   "both peers negotiated it at handshake; larger or non-msgpack "
   "bodies fall back to the legacy pickled-tuple frame. 0 disables "
   "the fast path.")

# --- serve plane (dynamic batching + queue-aware routing +
# backpressure-driven autoscaling; see docs/serve.md) ---
_D("serve_max_batch_size", int, 64,
   "Default per-dispatch batch cap for @serve.batch methods that "
   "don't set max_batch_size themselves: the router gathers up to "
   "this many pending requests into one vectorized replica call.")
_D("serve_batch_wait_timeout_ms", float, 2.0,
   "Default gather window for @serve.batch methods: once a batch "
   "has its first request, the router waits up to this long for "
   "more before dispatching a partial batch. A request arriving on "
   "an idle deployment (nothing dispatched, nothing pending) "
   "bypasses the wait entirely, so serial latency pays nothing.")
_D("serve_max_queued_requests", int, 10000,
   "Default bound on a deployment's total request queue (pending "
   "batches + in-flight + admission waiters) per routing process. "
   "Requests beyond it are shed with a retryable BackpressureError "
   "(HTTP ingress maps it to 503 + Retry-After) instead of queueing "
   "without limit. Per-deployment max_queued_requests overrides; "
   "0 disables the bound.")
_D("serve_autoscale_interval_s", float, 0.5,
   "Cadence of serve autoscaling decisions: each interval the "
   "controller folds a deployment's total load (queue depth + "
   "ongoing requests) into an EWMA and resizes toward "
   "ceil(ewma / target_ongoing_requests) within "
   "[min_replicas, max_replicas].")
_D("serve_autoscale_ewma_alpha", float, 0.5,
   "Smoothing factor of the serve autoscaler's load EWMA (weight of "
   "the newest interval sample; 1.0 = instantaneous load, the "
   "pre-serve-plane behavior).")
_D("serve_http_ingress", str, "async",
   "HTTP ingress backend: 'async' (selector event loop — "
   "non-blocking HTTP/1.1 with keep-alive and pipelining, requests "
   "ride the router's promise-ref batched path, completion callbacks "
   "write responses; docs/serve.md §Ingress) or 'threaded' (the "
   "legacy stdlib thread-per-request server, kept for comparison "
   "and as an escape hatch).")
_D("serve_http_pipeline_max", int, 128,
   "Per-connection cap on pipelined requests awaiting responses at "
   "the async ingress. A connection at the cap stops being READ from "
   "(natural TCP backpressure) until responses drain — the bound "
   "that keeps per-connection ingress state finite.")
_D("serve_http_write_buffer_bytes", int, 1 << 20,
   "Per-connection outbound high-water mark at the async ingress: "
   "past it, streaming item consumption pauses (and head-of-line "
   "response flushing continues) until the client drains below it — "
   "a slow reader backpressures its own stream instead of buffering "
   "without bound.")
_D("serve_http_request_timeout_s", float, 120.0,
   "Async-ingress per-request deadline: a request whose response "
   "has not started after this long answers 504 and releases its "
   "promise ref (matches the legacy handler's blocking-get "
   "timeout). 0 disables the sweep.")
_D("serve_zero_copy_threshold_bytes", int, 65536,
   "Request arguments at or above this size (bytes/bytearray/"
   "ndarray) are put into the object store once at the handle and "
   "routed as refs — each extra hop (proxy, composed handle, "
   "batched dispatch) then moves a fixed-size id instead of "
   "re-pickling the payload; the replica reads it zero-copy from "
   "shm. 0 disables ref promotion.")

# --- streaming data plane (docs/data_pipeline.md) ---
_D("data_block_target_bytes", int, 64 * 1024 * 1024,
   "Map outputs larger than this split into multiple row-sliced "
   "blocks inside the producing task (dynamic block splitting), so "
   "no single object outgrows the store's comfort zone and "
   "downstream stages parallelize over the pieces.")
_D("data_max_in_flight", int, 8,
   "Count cap on concurrently running tasks per map stage (the byte "
   "budget is the primary backpressure signal; this is the fallback "
   "concurrency bound).")
_D("data_prefetch_batches", int, 2,
   "Batches buffered ahead of the consumer by the prefetching "
   "iterators (iter_batches(prefetch_batches=...) defaults, trainer "
   "ingestion). 0 disables prefetch.")
_D("data_max_block_retries", int, 3,
   "Re-drives of one input block after its map task/actor died "
   "mid-block (data-plane lineage reconstruction). Exceeding the "
   "budget surfaces the last typed error to the consumer.")

# --- overload plane (reference: memory monitor + backpressured
# submission; see docs/fault_tolerance.md "Overload semantics") ---
_D("raylet_max_queued_tasks", int, 4096,
   "Bounded raylet scheduler intake: submits beyond this many queued "
   "payloads are shed with a retryable BackpressureError instead of "
   "queuing without limit. 0 disables the bound.")
_D("raylet_inflight_window", int, 1024,
   "Owner-side cap on submitted-but-uncompleted normal-task leases "
   "per remote raylet; excess dispatches wait briefly and retry. "
   "0 disables the window.")
_D("backpressure_retry_base_ms", int, 50,
   "Initial delay before re-submitting a shed task; doubles per "
   "consecutive shed (seeded jitter applied).")
_D("backpressure_retry_max_ms", int, 2000,
   "Shed-retry backoff ceiling.")
_D("owner_max_pending_tasks", int, 0,
   "Bounded nested-submission intake at the owner: nested_submit "
   "calls arriving while this many submitted tasks are queued but "
   "not yet executing are shed with BackpressureError (the in-worker "
   "client retries with backoff). Executing tasks don't count — "
   "blocked parents must stay able to submit the children they wait "
   "on. 0 disables the bound.")
_D("memory_watchdog_threshold", float, 0.95,
   "Node memory usage fraction above which the raylet's watchdog "
   "kills the largest retryable running task. The fraction is "
   "whole-host usage ((MemTotal - MemAvailable) / MemTotal) by "
   "default, or this raylet's own footprint (process-tree RSS + "
   "object-store bytes) over memory_watchdog_total_bytes when that "
   "is set. <= 0 disables the watchdog.")
_D("memory_watchdog_total_bytes", int, 0,
   "Explicit denominator of the watchdog usage fraction (containers, "
   "tests); 0 = host mode, reading whole-host usage from "
   "/proc/meminfo.")
_D("task_oom_retries", int, 3,
   "Owner-side retry budget for tasks killed by the memory watchdog "
   "(separate from max_retries; exponential backoff between "
   "attempts).")

# --- gang fault tolerance (collective groups; see
# docs/fault_tolerance.md "Gang semantics") ---
_D("gang_max_restarts", int, 1,
   "Coordinated-restart budget per collective gang: a member-actor "
   "death aborts the group (epoch bump + CollectiveAbortError to "
   "in-op ranks) and, while budget remains, kills and restarts ALL "
   "members together, re-forming the group at the new epoch. 0 = a "
   "member death kills the gang permanently. Per-group override via "
   "create_collective_group(gang_max_restarts=...).")
_D("gang_reform_timeout_s", float, 60.0,
   "How long a coordinated gang restart waits for every member to be "
   "ALIVE again (and the re-join barrier to complete) before the gang "
   "is declared DEAD.")

# --- multi-slice runtime plane (slice-gangs + DCN tier; see
# docs/multislice.md) ---
_D("dcn_latency_ms", float, 0.0,
   "Simulated one-way latency of the cross-slice DCN tier, charged "
   "once per remote rank-file read in a DCN collective "
   "(ray_tpu_torch/multislice/dcn.py). 0 disables the latency term — the "
   "shared-memory transport then runs at host speed. The bench sets "
   "realistic values to report cross-slice step overhead.")
_D("dcn_gbps", float, 0.0,
   "Simulated DCN per-link bandwidth in gigabits per second; the "
   "transfer term bytes*8/(dcn_gbps*1e9) is charged per remote "
   "rank-file read. 0 disables the bandwidth term (infinite link).")

# --- stateful recovery (checkpointable actors; see
# docs/fault_tolerance.md "Checkpoint semantics") ---
_D("actor_checkpoint_keep", int, 2,
   "Committed checkpoint generations kept per actor (a recovery "
   "ring, not an archive): older committed generations are pruned at "
   "commit time. At least 1; the restore path falls back one "
   "generation per load failure within whatever is kept.")

# --- cluster autoscaler v2 (docs/autoscaler.md) ---
_D("autoscaler_upscale_delay_s", float, 0.5,
   "Sustained unmet-demand pressure required before the reconciler "
   "queues launches. Direction-stable (mirrors the serve "
   "autoscaler's): a direction flip resets the timer, so the two "
   "control loops compose without oscillation.")
_D("autoscaler_downscale_delay_s", float, 2.0,
   "Sustained idle pressure (beyond idle_timeout_s) required before "
   "a drain starts; any unmet demand resets it.")
_D("autoscaler_request_timeout_s", float, 3.0,
   "QUEUED->REQUESTED transition deadline: a launch request the "
   "cloud never acknowledged (chaos 'drop' at "
   "autoscaler.provider.launch) is declared lost after this long "
   "and re-launched from the retry budget.")
_D("autoscaler_allocate_timeout_s", float, 30.0,
   "REQUESTED->ALLOCATED->RUNNING deadline: an allocation stuck "
   "pending (or a node that never joins the ray view) is released "
   "and re-launched from the retry budget.")
_D("autoscaler_launch_backoff_base_s", float, 0.05,
   "Seeded-backoff base between re-launch attempts (doubles per "
   "attempt, jittered; see _private/backoff.py).")
_D("autoscaler_launch_backoff_cap_s", float, 2.0,
   "Re-launch backoff ceiling.")
_D("autoscaler_drain_timeout_s", float, 10.0,
   "Scale-down drain budget: checkpoint saves + running-lease drain "
   "+ actor migration must finish inside it or the node is "
   "uncordoned and kept.")

# --- chaos / fault injection (tests only; see _private/chaos.py) ---
_D("chaos_rules", str, "",
   "Fault-injection rules (component.point.method:action[...]; "
   "';'-separated). Empty = chaos plane disarmed. The RTPU_CHAOS "
   "env var overrides per-process.")
_D("chaos_seed", int, 0,
   "Seed for probabilistic chaos rules; fixed seed = reproducible "
   "firing sequence.")

# --- gcs / health ---
_D("gcs_mode", str, "inproc",
   "'inproc' hosts the GCS tables in the driver; 'process' spawns a "
   "standalone GCS server process and talks to it over the wire.")
_D("health_check_period_ms", int, 1000, "GCS -> node health ping period.")
_D("health_check_failure_threshold", int, 5,
   "Missed pings before a node is declared dead.")

# --- logging / events ---
_D("event_log_enabled", bool, True, "Structured event log to session dir.")
_D("event_export_enabled", bool, False,
   "Write JSONL event streams (TASK/ACTOR/NODE) + an end-of-session "
   "usage_stats.json under the session dir for external collectors. "
   "Opt-in (matching the reference's export API): the TASK stream "
   "costs two records per task, which is measurable on the data-plane "
   "hot path. The in-memory event ring (event_log_enabled) stays on "
   "by default and keeps powering the timeline API.")
_D("log_level", str, "INFO", "Runtime log level.")
_D("log_to_driver", bool, True,
   "Stream worker stdout/stderr (local files + remote raylet "
   "read_logs) to the driver's stderr.")


_global_config: Config | None = None
_global_lock = threading.Lock()


def get_config() -> Config:
    global _global_config
    if _global_config is None:
        with _global_lock:
            if _global_config is None:
                _global_config = Config()
    return _global_config
