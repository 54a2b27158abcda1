"""Invariant oracle: gauge primitives, settle checks, and the typed
end-of-run verdict.

The gauge primitives here are the single implementation behind the
soak runner's per-phase checks — one definition of "this gauge is back
at baseline". Counterpart of ``ray_tpu/soak/oracle.py``: the gauge names
keep the reference's ``ray_tpu_*`` prefix, as the port's metrics do, and
the sanitizer is the port's ``ray_tpu_torch.devtools.sanitizer``.

Invariants asserted (ray_tpu_torch/docs/soak.md has the full table):

- **no lost results** — every ingress request, churn task, and
  trainer epoch reaches a terminal outcome: a correct value or a
  typed error. A hang, a truncated stream without a typed terminal
  record, or a wrong value counts as lost.
- **exactly-once side effects** — each idempotency token's effect
  applied exactly once (token ledger), trainer state equal to the
  analytic total (a dropped or duplicated batch moves it off).
- **gauges at baseline** — after every phase disarms (ingress
  paused), the live ``ray_tpu_*`` gauges drain: serve queue depth,
  ongoing/queued requests, backpressured tasks; after final drain the
  data-plane byte gauges vanish too.
- **bounded p99 inflation** — chaos-window p99 vs the calm warm-up
  window p99 (report-only when no bound is configured).
- **zero graftsan violations** — when ``RTPU_SANITIZE=1``, the
  sanitizer ring + JSONL artifact stay empty.
- **replayable fault timeline** — the fault-event log's digest equals
  a dry-run regeneration from the same seed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>[-+0-9.eE]+)\s*$")


# ---------------------------------------------------------------------------
# gauge primitives


def prometheus_lines(text: Optional[str] = None) -> List[str]:
    if text is None:
        from ray_tpu_torch.util import metrics
        text = metrics.prometheus_text()
    return text.splitlines()


def _parse_labels(blob: Optional[str]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    if not blob:
        return out
    for part in blob.split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        out[k.strip()] = v.strip().strip('"')
    return out


def gauge_samples(name: str, text: Optional[str] = None
                  ) -> List[Tuple[Dict[str, str], float]]:
    """Every sample of metric ``name`` as ``(labels, value)`` pairs."""
    out: List[Tuple[Dict[str, str], float]] = []
    for line in prometheus_lines(text):
        if not line.startswith(name):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None or m.group("name") != name:
            continue
        out.append((_parse_labels(m.group("labels")),
                    float(m.group("value"))))
    return out


def gauge_value(name: str, labels: Optional[Dict[str, str]] = None,
                text: Optional[str] = None) -> Optional[float]:
    """Value of the first sample of ``name`` whose labels include
    ``labels`` (None if the series is absent)."""
    want = labels or {}
    for got, value in gauge_samples(name, text):
        if all(got.get(k) == v for k, v in want.items()):
            return value
    return None


def wait_settled(probes: Sequence[Tuple[str, Callable[[], bool]]],
                 timeout: float = 20.0, interval: float = 0.1
                 ) -> Tuple[bool, str]:
    """Deadline-poll until every ``(description, predicate)`` probe
    holds in the SAME round (no fixed windows — the deflake idiom).
    Returns ``(ok, detail)``; detail names the probes still failing."""
    deadline = time.monotonic() + timeout
    failing: List[str] = [d for d, _ in probes]
    while time.monotonic() < deadline:
        failing = []
        for desc, pred in probes:
            try:
                if not pred():
                    failing.append(desc)
            except Exception as e:            # probe itself unhappy
                failing.append(f"{desc} (probe error: {e!r})")
        if not failing:
            return True, ""
        time.sleep(interval)
    return False, "still failing: " + "; ".join(failing)


def serve_settle_probes(deployments: Sequence[str]
                        ) -> List[Tuple[str, Callable[[], bool]]]:
    """The serve plane's settle-set: no queued or ongoing requests in
    ``serve.status()`` and the queue-depth gauge at zero, per
    deployment — the assertion previously duplicated across the
    overload/batching/ingress tests."""
    from ray_tpu_torch import serve

    def _status_quiet(name: str) -> Callable[[], bool]:
        def check() -> bool:
            st = serve.status().get(name)
            if st is None:
                return True      # deployment gone: nothing to drain
            return (st["queued_requests"] == 0
                    and st["ongoing_requests"] == 0)
        return check

    def _gauge_zero(name: str) -> Callable[[], bool]:
        def check() -> bool:
            v = gauge_value("ray_tpu_serve_queue_depth",
                            {"deployment": name})
            return v is None or v == 0
        return check

    probes: List[Tuple[str, Callable[[], bool]]] = []
    for name in deployments:
        probes.append((f"serve.status[{name}] queued/ongoing == 0",
                       _status_quiet(name)))
        probes.append(
            (f'ray_tpu_serve_queue_depth{{deployment="{name}"}} == 0',
             _gauge_zero(name)))
    return probes


def serve_settle_probe(name: str) -> List[Tuple[str, Callable[[], bool]]]:
    return serve_settle_probes([name])


def backpressure_settle_probe() -> Tuple[str, Callable[[], bool]]:
    def check() -> bool:
        v = gauge_value("ray_tpu_tasks", {"state": "backpressured"})
        return v is None or v == 0
    return ('ray_tpu_tasks{state="backpressured"} == 0', check)


def data_drained_probe() -> Tuple[str, Callable[[], bool]]:
    def check() -> bool:
        from ray_tpu_torch._private import data_stats
        return data_stats.queued_bytes_by_stage() == {}
    return ("data_stats.queued_bytes_by_stage() == {}", check)


def percentile(samples: Sequence[float], q: float) -> Optional[float]:
    if not samples:
        return None
    xs = sorted(samples)
    k = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
    return xs[k]


# ---------------------------------------------------------------------------
# the verdict


@dataclasses.dataclass
class InvariantResult:
    name: str
    ok: bool
    detail: str = ""
    skipped: bool = False

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SoakVerdict:
    """Typed end-of-run report: one row per invariant plus the run's
    observed counters. ``ok`` is the conjunction of every
    non-skipped invariant."""

    seed: int
    duration: float
    invariants: List[InvariantResult]
    counts: Dict[str, float]
    digest: str = ""

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.invariants if not r.skipped)

    def to_dict(self) -> Dict:
        return {"seed": self.seed, "duration": self.duration,
                "ok": self.ok, "digest": self.digest,
                "counts": dict(self.counts),
                "invariants": [r.to_dict() for r in self.invariants]}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=1)

    def render(self) -> str:
        rows = []
        for r in self.invariants:
            mark = ("SKIP" if r.skipped else "ok  " if r.ok else "FAIL")
            rows.append(f"  [{mark}] {r.name}"
                        + (f" — {r.detail}" if r.detail else ""))
        head = (f"soak verdict: seed={self.seed} "
                f"duration={self.duration}s "
                f"{'PASS' if self.ok else 'FAIL'}")
        counts = "  counts: " + ", ".join(
            f"{k}={v}" for k, v in sorted(self.counts.items()))
        return "\n".join([head, *rows, counts,
                          f"  timeline digest: {self.digest}"])


def graftsan_violations() -> Tuple[Optional[int], str]:
    """(count, detail) of sanitizer violations this process and its
    children produced; ``(None, ...)`` when graftsan is disabled."""
    from ray_tpu_torch.devtools import sanitizer
    if not sanitizer.enabled():
        return None, "RTPU_SANITIZE not set"
    count = len(sanitizer.reporter().snapshot())
    log = os.environ.get("RTPU_SANITIZE_LOG", "")
    if log:
        logged, _ = sanitizer.read_log(log, 0)
        count += len(logged)
    return count, (f"{count} violation(s)" if count else "")
