"""Process-local data-plane counters (docs/data_pipeline.md
§Observability).

Lives in ``_private`` (not the data package) for the same reason as
``serve_stats``: the runtime metrics collector must read these at
scrape time without importing ``ray_tpu_torch.data`` (whose ``__init__``
imports ``ray_tpu_torch`` — a ``stats.py -> data`` edge would close that
cycle). The streaming executor pushes counters here; ``stats.py``
reads them when /metrics is scraped.

Two kinds of state:

- cumulative **counters** (blocks produced/consumed/reconstructed,
  backpressure events, zero-copy handoffs, locality hits/misses) —
  monotone per process, deltas are the bench signal;
- a weak registry of **live executors**, each exposing
  ``queued_bytes_by_stage()`` — the scrape walks live runs only, so
  the ``ray_tpu_data_queued_bytes{stage}`` family returns to baseline
  (series vanish) once a pipeline finishes and its executor is
  collected or marked done.

The port's copy of ``ray_tpu/_private/data_stats.py``; the gauges keep
the reference's ``ray_tpu_`` names, as Serve's do.
"""

from __future__ import annotations

import threading
import weakref

_lock = threading.Lock()

# cumulative counters
_counters = {  # guarded-by: _lock
    "blocks_produced": 0,       # map/read outputs handed downstream
    "blocks_consumed": 0,       # outputs yielded to the consumer
    "blocks_reconstructed": 0,  # inputs re-driven after a worker death
    "bytes_produced": 0,        # stored bytes of produced blocks
    "backpressure_events": 0,   # launches deferred by a byte budget
    "zero_copy_blocks": 0,      # blocks handed off via shm (no copy)
    "locality_hits": 0,         # actor-pool dispatches co-located with
                                # the block's bytes
    "locality_misses": 0,       # dispatches that crossed nodes
}

# Live StreamingExecutor segment runs (weak: a finished/leaked run
# must not be kept alive by the metrics plane). Each entry answers
# queued_bytes_by_stage() -> {stage_label: bytes}.
_executors: "weakref.WeakSet" = weakref.WeakSet()

# Most recent trainer-ingest starvation report (fraction of wall time
# the train loop spent waiting on the data iterator).
_starvation = {"fraction": 0.0}  # guarded-by: _lock


def incr(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def snapshot() -> dict:
    with _lock:
        return dict(_counters)


def register_executor(ex) -> None:
    _executors.add(ex)


def executors() -> list:
    return list(_executors)


def queued_bytes_by_stage() -> dict:
    """Union of per-stage queued bytes across live pipeline runs
    (labels collide only when two live runs share a stage name; the
    values then sum, which is the honest cluster-wide reading)."""
    out: dict = {}
    for ex in list(_executors):
        try:
            for stage, nb in ex.queued_bytes_by_stage().items():
                out[stage] = out.get(stage, 0) + nb
        except Exception:  # noqa: BLE001
            pass    # executor mid-teardown: skip its series this scrape
    return out


def set_starvation(fraction: float) -> None:
    with _lock:
        _starvation["fraction"] = float(fraction)


def starvation() -> float:
    with _lock:
        return _starvation["fraction"]


def reset() -> None:
    """Test hook: zero the counters in place (references stay live)."""
    with _lock:
        for k in _counters:
            _counters[k] = 0
        _starvation["fraction"] = 0.0
