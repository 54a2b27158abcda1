"""Process-local serve-plane counters (docs/serve.md §Observability).

Lives in ``_private`` (not the serve package) so the runtime metrics
collector can import it without pulling the serve control plane —
``serve/__init__`` imports the controller which imports ``ray_tpu_torch``,
and a ``stats.py -> serve`` edge would close that cycle. The serve
modules push counters here; ``stats.py`` reads them at scrape time.

Counters are cumulative per process; the RPS gauge is derived from
the request counter's delta between scrapes.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque

_lock = threading.Lock()

# cumulative counters
_counters = {  # guarded-by: _lock
    "requests": 0,        # requests accepted into a router
    "shed": 0,            # requests shed with BackpressureError
    "batches": 0,         # batched dispatches sent to replicas
    "batch_items": 0,     # requests carried by those dispatches
    "batch_retries": 0,   # whole-batch retries after a replica death
    "streams": 0,         # streaming requests started at an ingress
    "stream_items": 0,    # items written to streaming clients
    "stream_errors": 0,   # streams ended by a TYPED terminal event
}

# First-token latency window (streaming requests: request parsed ->
# first item on the wire). Bounded ring: the gauge reports the mean of
# the most recent samples, old ones age out by displacement.
_first_token_ms: deque = deque(maxlen=1024)  # guarded-by: _lock

# Live ServeController instances (weak: a shut-down controller must
# not be kept alive by the metrics plane).
_controllers: "weakref.WeakSet" = weakref.WeakSet()

# RPS window state
_rps_prev = {"t": None, "n": 0}  # guarded-by: _lock


def incr(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def register_controller(controller) -> None:
    _controllers.add(controller)


def controllers() -> list:
    return list(_controllers)


def snapshot() -> dict:
    with _lock:
        return dict(_counters)


def observe_first_token(ms: float) -> None:
    """Record one streaming request's first-token latency (ms)."""
    with _lock:
        _first_token_ms.append(float(ms))


def first_token_ms() -> float:
    """Mean first-token latency over the recent sample window (the
    ``ray_tpu_serve_first_token_ms`` gauge; 0.0 = no streamed load)."""
    with _lock:
        if not _first_token_ms:
            return 0.0
        return sum(_first_token_ms) / len(_first_token_ms)


def batch_avg() -> float:
    """Realized requests-per-dispatch on the batched path."""
    with _lock:
        b = _counters["batches"]
        return (_counters["batch_items"] / b) if b else 0.0


def rps_sample(now: float = None) -> float:
    """Requests/s since the previous scrape (first scrape returns 0).
    Called once per metrics collection; calling it more often just
    shortens the window."""
    if now is None:
        now = time.monotonic()
    with _lock:
        n = _counters["requests"]
        prev_t, prev_n = _rps_prev["t"], _rps_prev["n"]
        _rps_prev["t"], _rps_prev["n"] = now, n
        if prev_t is None or now <= prev_t:
            return 0.0
        return (n - prev_n) / (now - prev_t)


def reset() -> None:
    """Test hook: zero the counters in place (references stay live)."""
    with _lock:
        for k in _counters:
            _counters[k] = 0
        _rps_prev["t"], _rps_prev["n"] = None, 0
        _first_token_ms.clear()
