"""lock-order: whole-program lock-acquisition graph vs declared
canonical orders (and cycle detection).

The runtime's hot paths are lock-heavy and the canonical acquisition
orders used to live in prose comments (the raylet's
``_push_order_lock -> _push_lock -> ctx._send_lock`` flush discipline)
— nothing checked them, and a flush race of the JAX package was a reviewer
catching an inversion by hand. This pass promotes those comments to a
machine-readable declaration::

    # lock-order: _push_order_lock -> _push_lock -> ConnectionContext._send_lock

Grammar: elements left-of ``->`` must be acquired before elements
right of it. A bare name binds to the class whose body encloses the
comment; ``Class.name`` (or a module-level comment) binds explicitly.
Declarations are additive — several per file/class are fine.

Phase 2 builds the project lock-acquisition graph from the linked
summaries: an edge A -> B means some code path acquires B while
holding A, either by direct lexical nesting or transitively through
the call graph (including locks passed as parameters, the
``_send_frame(sock, obj, lock)`` pattern). Reported:

- **inversion**: an edge B -> A where a single declaration orders A
  before B (anchored at the acquiring site, citing the declaration);
- **cycle**: a strongly-connected ring in the acquisition graph —
  reported even with no declaration in sight (two code paths that
  nest the same two locks in opposite orders can deadlock no matter
  what the canon says). A ring whose back-edge is already reported as
  an inversion is not double-reported.

Lock identity is class-qualified ((owner class, attr)), so
``NodeManagerGroup._lock`` vs ``DependencyManager._lock`` never
collide; acquisitions that cannot be attributed to at most two
defining classes produce no edge (precision over recall — this runs
in tier-1 and must not cry wolf). ``# lock-order-ok: <why>`` on an
acquisition or call line exempts that site's edges.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ray_tpu_torch.devtools.analysis.core import Finding

PASS_ID = "lock-order"
VERSION = 1

_SCOPES = ("_private/", "collective/", "multislice/", "serve/",
           "analysis_fixtures/")


def _node_str(node: Tuple[str, str]) -> str:
    owner, name = node
    return f"{owner}.{name}"


def _in_scope(path: str) -> bool:
    return any(s in path for s in _SCOPES)


def check_graph(graph) -> List[Finding]:
    edges = [e for e in graph.lock_edges() if _in_scope(e[2])]
    findings: List[Finding] = []

    # -- inversions against declarations -------------------------------
    decls = graph.declarations()
    inverted_pairs = set()
    seen = set()
    for held, acquired, path, line, via in edges:
        for dpath, dline, nodes, elements in decls:
            if held not in nodes or acquired not in nodes:
                continue
            if nodes.index(held) <= nodes.index(acquired):
                continue
            key = (held, acquired, path, line)
            if key in seen:
                continue
            seen.add(key)
            inverted_pairs.add((held, acquired))
            inverted_pairs.add((acquired, held))
            chain = f" ({via})" if via else ""
            scope = _scope_at(graph, path, line)
            findings.append(Finding(
                PASS_ID, path, line, scope,
                f"lock-order inversion: {_node_str(acquired)} acquired "
                f"while holding {_node_str(held)}{chain}, but {dpath} "
                f"declares `# lock-order: {' -> '.join(elements)}`"))

    # -- cycles ---------------------------------------------------------
    adj: Dict[Tuple[str, str], set] = {}
    evidence: Dict[tuple, tuple] = {}
    for held, acquired, path, line, via in edges:
        adj.setdefault(held, set()).add(acquired)
        adj.setdefault(acquired, set())
        evidence.setdefault((held, acquired), (path, line, via))
    for ring in _cycles(adj):
        ring_edges = list(zip(ring, ring[1:] + ring[:1]))
        if not all(pair in evidence for pair in ring_edges):
            continue    # greedy ring walk failed to close; skip rather
            # than fabricate evidence for a non-edge
        if all(pair in inverted_pairs for pair in ring_edges):
            continue    # fully covered by inversion findings above
        path, line, _via = min(evidence[p] for p in ring_edges)
        desc = " -> ".join(_node_str(n) for n in ring + ring[:1])
        parts = []
        for (a, b) in ring_edges:
            epath, eline, evia = evidence[(a, b)]
            parts.append(f"{_node_str(b)} under {_node_str(a)} at "
                         f"{epath}:{eline}" + (f" {evia}" if evia else ""))
        findings.append(Finding(
            PASS_ID, path, line, _scope_at(graph, path, line),
            f"lock-order cycle: {desc} — two code paths nest these "
            f"locks in opposite orders and can deadlock "
            f"({'; '.join(parts)})"))
    return findings


def _scope_at(graph, path: str, line: int) -> str:
    """Enclosing function qualname from the summary (no AST on hand in
    phase 2 — summaries carry def lines, pick the tightest one whose
    file matches)."""
    best = None
    s = graph.summaries.get(path)
    if s:
        for qual, data in s.get("functions", {}).items():
            if data["line"] <= line and (best is None
                                         or data["line"] > best[0]):
                best = (data["line"], qual)
    return best[1] if best else "<module>"


def _cycles(adj: Dict) -> List[List]:
    """Elementary cycles via Tarjan SCCs; each non-trivial SCC is
    reported once as a representative ring (deterministic order)."""
    index: Dict = {}
    low: Dict = {}
    on_stack: Dict = {}
    stack: List = []
    counter = [0]
    sccs: List[List] = []

    def strongconnect(v) -> None:
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack[v] = True
        for w in sorted(adj.get(v, ())):
            if w not in index:
                strongconnect(w)
                low[v] = min(low[v], low[w])
            elif on_stack.get(w):
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                on_stack[w] = False
                comp.append(w)
                if w == v:
                    break
            if len(comp) > 1:
                sccs.append(sorted(comp))

    for v in sorted(adj):
        if v not in index:
            strongconnect(v)

    rings = []
    for comp in sccs:
        # representative ring: walk the SCC greedily from its smallest
        # node along in-SCC edges until it closes
        comp_set = set(comp)
        ring = [comp[0]]
        while True:
            nxt = None
            for w in sorted(adj.get(ring[-1], ())):
                if w in comp_set:
                    if w == ring[0] and len(ring) > 1:
                        nxt = w
                        break
                    if w not in ring:
                        nxt = w
                        break
            if nxt is None or nxt == ring[0]:
                break
            ring.append(nxt)
        rings.append(ring)
    return rings
