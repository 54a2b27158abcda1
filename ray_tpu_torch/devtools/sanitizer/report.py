"""graftsan violation reporting: bounded in-process ring + JSONL
artifact + observed-pair dump.

Violations are deduplicated on a per-kind key (one AB/BA inversion =
one report, not one per occurrence), kept in a bounded ring (a
misbehaving loop can't eat the process's memory), and appended to the
JSONL file named by ``RTPU_SANITIZE_LOG`` when set. The env var is
the cross-process channel: spawned raylet/GCS/worker children inherit
it, so one sanitized test run funnels every process's violations into
one artifact the conftest teardown check reads back.

Observed lock-acquisition pairs are dumped at exit to
``RTPU_SANITIZE_OBSERVED`` (JSONL) for
``python -m ray_tpu_torch.devtools.sanitizer --diff``: runtime-observed
orders not covered by a ``# lock-order:`` declaration get *promoted*
into annotations instead of rotting as tribal knowledge.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
from collections import deque
from typing import Dict, List, Optional

import _thread

RING_SIZE = 256


class Violation:
    __slots__ = ("kind", "key", "message", "stacks", "pid")

    def __init__(self, kind: str, key: str, message: str,
                 stacks: Dict[str, str]):
        self.kind = kind
        self.key = key
        self.message = message
        self.stacks = stacks        # label -> formatted stack text
        self.pid = os.getpid()

    def to_json(self) -> dict:
        return {"kind": self.kind, "key": self.key,
                "message": self.message, "stacks": self.stacks,
                "pid": self.pid,
                "thread": threading.current_thread().name}

    def render(self) -> str:
        out = [f"[{self.kind}] {self.message}"]
        for label, stack in self.stacks.items():
            out.append(f"  --- {label} ---")
            out.extend("  " + ln for ln in stack.rstrip().splitlines())
        return "\n".join(out)


class Reporter:
    """Process-wide sink. Internal state uses a RAW lock — the
    reporter runs inside instrumented acquire paths and must never
    recurse into the instrumentation."""

    def __init__(self) -> None:
        self._mu = _thread.allocate_lock()
        self.ring: deque = deque(maxlen=RING_SIZE)
        self._seen: set = set()
        self.dropped = 0
        self.log_path = os.environ.get("RTPU_SANITIZE_LOG") or None

    def violation(self, kind: str, key: str, message: str,
                  stacks: Optional[Dict[str, str]] = None) -> bool:
        """Record once per (kind, key); returns False on dedup."""
        v = Violation(kind, key, message, stacks or {})
        with self._mu:
            if (kind, key) in self._seen:
                return False
            self._seen.add((kind, key))
            if len(self.ring) == self.ring.maxlen:
                self.dropped += 1
            self.ring.append(v)
        if self.log_path:
            try:
                with open(self.log_path, "a", encoding="utf-8") as f:
                    f.write(json.dumps(v.to_json()) + "\n")
            except OSError:
                pass
        return True

    def snapshot(self) -> List[Violation]:
        with self._mu:
            return list(self.ring)

    def clear(self) -> None:
        with self._mu:
            self.ring.clear()
            self._seen.clear()
            self.dropped = 0


_reporter: Optional[Reporter] = None


def reporter() -> Reporter:
    global _reporter
    if _reporter is None:
        _reporter = Reporter()
    return _reporter


def read_log(path: str, offset: int = 0) -> tuple:
    """(violations, new_offset) from a JSONL artifact, starting at
    byte ``offset`` — the conftest teardown watermark, so each test
    only answers for violations IT produced (its own process or any
    child sharing the inherited env)."""
    try:
        with open(path, encoding="utf-8") as f:
            f.seek(offset)
            chunk = f.read()
            new_offset = f.tell()
    except OSError:
        return [], offset
    out = []
    for line in chunk.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except ValueError:
            pass        # torn concurrent write: counted next read
    return out, new_offset


def install_pair_dump(pairs_fn) -> None:
    """At exit, append this process's observed lock pairs to
    ``RTPU_SANITIZE_OBSERVED`` (when set) for the --diff workflow."""
    path = os.environ.get("RTPU_SANITIZE_OBSERVED")
    if not path:
        return

    def _dump() -> None:
        try:
            with open(path, "a", encoding="utf-8") as f:
                for rec in pairs_fn():
                    f.write(json.dumps(rec) + "\n")
        except OSError:
            pass

    atexit.register(_dump)


def diff_observed(observed_path: str, manifest: dict) -> List[dict]:
    """Observed pairs not covered by any declared ``# lock-order:``.
    A pair (a, b) is covered when some declaration lists both with a
    before b. Returns records to promote into annotations."""
    declared = []
    for decl in manifest.get("orders", []):
        idx = {name: i for i, name in enumerate(decl["nodes"])}
        declared.append((idx, decl))
    seen = set()
    out = []
    try:
        with open(observed_path, encoding="utf-8") as f:
            lines = f.read().splitlines()
    except OSError:
        return []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        a, b = rec.get("held"), rec.get("acquired")
        if not a or not b or (a, b) in seen:
            continue
        seen.add((a, b))
        covered = any(
            a in idx and b in idx and idx[a] < idx[b]
            for idx, _ in declared)
        if not covered:
            out.append(rec)
    return out
