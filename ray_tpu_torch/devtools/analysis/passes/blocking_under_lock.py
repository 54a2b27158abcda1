"""blocking-under-lock: no RPC round trip, sleep, fsync'd write,
subprocess, or blocking dequeue while a lock is held.

The review finding this pass mechanizes (in the JAX package first):
the gang plane held ``_gang_lock`` across GCS RPCs, so one stalled GCS
pinned every thread that touched gang state. The repo's discipline since is
snapshot-under-lock / block-outside-lock; this pass makes the
discipline structural. Flagged while any lock is held (lexically, or
via a ``# lock-held:`` annotation), directly or transitively through
the project call graph:

- ``.call(...)`` / ``.oneway(...)`` / ``._call(...)`` — synchronous
  RPC round trips (the wire can stall arbitrarily);
- ``time.sleep(...)`` (and bare ``sleep`` from ``from time import``);
- ``durable.*(...)`` and ``open(..., "w"/"a"/"x"/"+")`` — fsync'd or
  plain file writes (a slow disk stalls the lock);
- ``subprocess.*(...)``;
- ``.get(block=..., timeout=...)`` / ``.get()`` on a queue-named
  receiver — blocking dequeues.

Suppression: ``# blocking-ok: <why>`` on the blocking call's lines
(summary-time) or on the call site whose callee would transitively
block. The why must name the bound (e.g. "socket sendall under the
order lock IS the ordered-flush design" — though plain sends are
deliberately not in the kind list).

Scope: ``_private/``, ``collective/``, ``multislice/``, ``serve/``
(and the lint fixture tree) — the library layers above the runtime
block on user code by design.
"""

from __future__ import annotations

from typing import List

from ray_tpu_torch.devtools.analysis.core import Finding

PASS_ID = "blocking-under-lock"
VERSION = 1

_SCOPES = ("_private/", "collective/", "multislice/", "serve/",
           "analysis_fixtures/")

# Transitive chains longer than this are too speculative to report:
# real stalls show up within a couple of hops.
_MAX_CHAIN_HOPS = 3


def _in_scope(path: str) -> bool:
    return any(s in path for s in _SCOPES)


def check_graph(graph) -> List[Finding]:
    findings: List[Finding] = []
    seen = set()
    for fi in graph.by_key.values():
        if not _in_scope(fi.path):
            continue
        for ev in fi.data["events"]:
            held_specs = ev[-1]
            held_nodes: List = []
            for spec in held_specs:
                held_nodes.extend(graph.resolve_lock(fi, spec))
            if not held_nodes:
                continue
            lock_desc = ", ".join(f"{o}.{n}" for o, n in held_nodes)
            if ev[0] == "block":
                kind, desc, ok, line = ev[1], ev[2], ev[3], ev[4]
                if ok:
                    continue
                key = (fi.path, line, "direct")
                if key in seen:
                    continue
                seen.add(key)
                findings.append(Finding(
                    PASS_ID, fi.path, line, fi.qual,
                    f"{desc} while holding {lock_desc} — move it "
                    "outside the lock or annotate "
                    "`# blocking-ok: <why>`"))
            elif ev[0] == "call":
                callee, recv, meta, line = ev[1], ev[2], ev[3], ev[4]
                if meta.get("ok"):
                    continue
                for target in graph.resolve_call(fi, callee, recv):
                    sites = graph.blocking_closure(target)
                    if not sites:
                        continue
                    kind, desc, bpath, bline, chain = sites[0]
                    if chain.count("->") >= _MAX_CHAIN_HOPS:
                        continue
                    key = (fi.path, line, "transitive")
                    if key in seen:
                        continue
                    seen.add(key)
                    findings.append(Finding(
                        PASS_ID, fi.path, line, fi.qual,
                        f"call to {callee}() while holding {lock_desc} "
                        f"reaches {desc} at {bpath}:{bline} "
                        f"(chain: {fi.qual} -> {chain}) — move the "
                        "blocking work outside the lock or annotate "
                        "`# blocking-ok: <why>`"))
                    break
    return findings
