"""Metrics: user-defined Counter/Gauge/Histogram + Prometheus export.

Reference: ``python/ray/util/metrics.py`` (tag-based user metrics) and
``src/ray/stats/`` → per-node metrics agent → Prometheus scrape
[UNVERIFIED — mount empty, SURVEY.md §0]. One process-wide registry;
``start_metrics_server`` exposes the standard text format over HTTP.
The runtime's own counters (tasks, objects, scheduler) register here
too, so one scrape covers user + system series.
"""

from __future__ import annotations

import threading
from bisect import bisect_right
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

_REGISTRY_LOCK = threading.Lock()
_REGISTRY: Dict[str, "Metric"] = {}

DEFAULT_HISTOGRAM_BOUNDARIES = [
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0]


class Metric:
    kind = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        if not name.replace("_", "a").isalnum():
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._lock = threading.Lock()
        self._default_tags: Dict[str, str] = {}
        with _REGISTRY_LOCK:
            existing = _REGISTRY.get(name)
            if existing is not None and existing.kind != self.kind:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{existing.kind}")
            _REGISTRY[name] = self

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]) -> Tuple:
        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        unknown = set(merged) - set(self.tag_keys)
        if unknown:
            raise ValueError(f"unknown tag keys {sorted(unknown)} for "
                             f"metric {self.name!r}")
        return tuple(sorted(merged.items()))

    def _samples(self) -> List[Tuple[str, Tuple, float]]:
        raise NotImplementedError


class Counter(Metric):
    kind = "counter"

    def __init__(self, name, description: str = "",
                 tag_keys: Sequence[str] = ()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = defaultdict(float)

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("counters only increase")
        key = self._key(tags)
        with self._lock:
            self._values[key] += value

    def _samples(self):
        with self._lock:
            return [(self.name, k, v) for k, v in self._values.items()]


class Gauge(Metric):
    kind = "gauge"

    def __init__(self, name, description: str = "",
                 tag_keys: Sequence[str] = ()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        key = self._key(tags)
        with self._lock:
            self._values[key] = float(value)

    def _samples(self):
        with self._lock:
            return [(self.name, k, v) for k, v in self._values.items()]

    def clear(self) -> None:
        """Drop every series. Collector-refreshed gauges call this at
        scrape time so series for entities that no longer exist (dead
        nodes) disappear instead of exporting stale values forever."""
        with self._lock:
            self._values.clear()


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name, description: str = "",
                 boundaries: Optional[Sequence[float]] = None,
                 tag_keys: Sequence[str] = ()):
        super().__init__(name, description, tag_keys)
        self.boundaries = sorted(boundaries
                                 or DEFAULT_HISTOGRAM_BOUNDARIES)
        self._buckets: Dict[Tuple, List[int]] = {}
        self._sum: Dict[Tuple, float] = defaultdict(float)
        self._count: Dict[Tuple, int] = defaultdict(int)

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        key = self._key(tags)
        with self._lock:
            buckets = self._buckets.setdefault(
                key, [0] * (len(self.boundaries) + 1))
            buckets[bisect_right(self.boundaries, value)] += 1
            self._sum[key] += value
            self._count[key] += 1

    def _samples(self):
        out = []
        with self._lock:
            for key, buckets in self._buckets.items():
                cum = 0
                for i, le in enumerate(self.boundaries):
                    cum += buckets[i]
                    out.append((f"{self.name}_bucket",
                                key + (("le", str(le)),), cum))
                out.append((f"{self.name}_bucket",
                            key + (("le", "+Inf"),),
                            cum + buckets[-1]))
                out.append((f"{self.name}_sum", key, self._sum[key]))
                out.append((f"{self.name}_count", key, self._count[key]))
        return out


_collectors: List = []


def register_collector(fn) -> None:
    """``fn()`` runs at every scrape to refresh gauges from live
    runtime state (the pull-model equivalent of the reference's
    metrics agent export loop)."""
    _collectors.append(fn)


def unregister_collector(fn) -> None:
    try:
        _collectors.remove(fn)
    except ValueError:
        pass


def prometheus_text() -> str:
    """All registered metrics in Prometheus exposition format."""
    for fn in list(_collectors):
        try:
            fn()
        except Exception:
            pass    # one bad collector must not break the scrape
    lines: List[str] = []
    with _REGISTRY_LOCK:
        metrics = list(_REGISTRY.values())
    for metric in metrics:
        if metric.description:
            lines.append(f"# HELP {metric.name} {metric.description}")
        lines.append(f"# TYPE {metric.name} {metric.kind}")
        for name, key, value in metric._samples():
            if key:
                tags = ",".join(f'{k}="{v}"' for k, v in key)
                lines.append(f"{name}{{{tags}}} {value}")
            else:
                lines.append(f"{name} {value}")
    return "\n".join(lines) + "\n"


_server = None
_server_lock = threading.Lock()


def start_metrics_server(host: str = "127.0.0.1", port: int = 0):
    """Expose /metrics; returns (host, port)."""
    global _server
    import http.server

    class _Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):  # noqa: ANN002
            pass

        def do_GET(self):  # noqa: N802
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_error(404)
                return
            body = prometheus_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    with _server_lock:
        if _server is None:
            _server = http.server.ThreadingHTTPServer((host, port),
                                                      _Handler)
            threading.Thread(target=_server.serve_forever,
                             kwargs={"poll_interval": 0.2},
                             daemon=True,
                             name="rtpu-metrics").start()
        return _server.server_address


def stop_metrics_server() -> None:
    global _server
    with _server_lock:
        if _server is not None:
            _server.shutdown()
            _server.server_close()
            _server = None


def clear_registry() -> None:
    """Test helper: drop all registered metrics."""
    with _REGISTRY_LOCK:
        _REGISTRY.clear()
