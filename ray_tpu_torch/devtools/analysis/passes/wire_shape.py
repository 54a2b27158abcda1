"""wire-shape: tuple-only type gates on values that ride the RTF1
fastframe (msgpack normalizes tuples to lists in transported bodies).

The binary small-frame fast path (the JAX package's
docs/data_plane.md) encodes eligible
frames with msgpack, which has no tuple type: a tuple sent by one end
arrives as a *list*. ``_recv_frame`` re-tuples the outer frame, but
everything nested — handler arguments, payload elements — keeps the
msgpack shape. The JAX package twice shipped real bugs where a handler
gated on ``isinstance(x, tuple)`` and silently dropped fastframe
traffic. This pass mechanizes the review rule:

- **Taint sources**: the parameters (after the connection ctx) of
  every handler registered for a method in ``_FASTFRAME_SAFE``
  (collected from ``rpc.py``'s literal; lint fixtures may define
  their own so they stay self-contained).
- **Propagation**: through local copies / subscripts / unpacks /
  ``list()``/``tuple()`` wraps (summary-time flow map) and
  interprocedurally through call arguments into callee parameters.
- **Flagged**: ``isinstance(x, tuple)`` where ``list`` is absent from
  the type set, ``type(x) is tuple``, and ``case tuple(...)`` match
  patterns, applied to a tainted value. ``isinstance(x, (tuple,
  list))`` passes — that is the fix.
- **Suppression**: ``# wire-shape-ok: <why>`` on the gate's lines,
  stating why the value provably never rides RTF1 (e.g. the hub
  socket speaks ``multiprocessing.Connection`` pickle, never RTF1).

Scope: ``_private/``, ``collective/``, ``multislice/``, ``serve/``
(and the lint fixture tree).
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from ray_tpu_torch.devtools.analysis.core import Finding

PASS_ID = "wire-shape"
VERSION = 1

_SCOPES = ("_private/", "collective/", "multislice/", "serve/",
           "analysis_fixtures/")

_MAX_DEPTH = 5


def _in_scope(path: str) -> bool:
    return any(s in path for s in _SCOPES)


def check_graph(graph) -> List[Finding]:
    # fixpoint taint propagation: function key -> tainted param names,
    # plus the originating wire method for the finding's evidence
    tainted: Dict[str, Set[str]] = {}
    origin: Dict[str, str] = {}
    worklist: List[Tuple[object, Set[str], str, int]] = []
    for fi, params in graph.fastframe_handlers():
        method = _registered_method(graph, fi)
        worklist.append((fi, set(params), method, 0))

    while worklist:
        fi, params, method, depth = worklist.pop()
        have = tainted.setdefault(fi.key, set())
        new = params - have
        if not new or depth > _MAX_DEPTH:
            continue
        have.update(new)
        origin.setdefault(fi.key, method)
        tainted_vars = _tainted_vars(fi, have)
        for ev in fi.data["events"]:
            if ev[0] != "call":
                continue
            callee, recv, meta = ev[1], ev[2], ev[3]
            for pos, roots in meta.get("args", {}).items():
                if not any(r in tainted_vars for r in roots):
                    continue
                for target in graph.resolve_call(fi, callee, recv):
                    pname = _param_at(target, int(pos), recv)
                    if pname is not None:
                        worklist.append((target, {pname}, method,
                                         depth + 1))

    findings: List[Finding] = []
    for key, params in sorted(tainted.items()):
        fi = graph.by_key[key]
        if not _in_scope(fi.path):
            continue
        tainted_vars = _tainted_vars(fi, params)
        for line, var, desc, ok in fi.data["gates"]:
            if ok or var not in tainted_vars:
                continue
            findings.append(Finding(
                PASS_ID, fi.path, line, fi.qual,
                f"tuple-only gate `{desc}` on {var!r}, which can "
                f"arrive via the RTF1 fastframe (traced from wire "
                f"method {origin.get(key, '?')!r}) msgpack-normalized "
                "— tuples become lists. Accept `(tuple, list)` or "
                "annotate `# wire-shape-ok: <why it never rides "
                "RTF1>`"))
    return findings


def _registered_method(graph, fi) -> str:
    for path, s in graph.summaries.items():
        for name, _line, _ext, target, _scope in s.get("rpc_regs", []):
            if target == fi.name and name in graph.fastframe_safe:
                return name
    return "?"


def _tainted_vars(fi, params: Set[str]) -> Set[str]:
    flow = fi.data.get("taint_flow", {})
    out = set(params)
    for var, srcs in flow.items():
        if set(srcs) & params:
            out.add(var)
    return out


def _param_at(target, pos: int, recv: str):
    """Callee parameter name receiving positional arg ``pos``; bound
    methods called attr-style consume their ``self`` implicitly."""
    params = list(target.data["params"])
    if params and params[0] in ("self", "cls") and recv:
        params = params[1:]
    if pos < len(params):
        return params[pos].lstrip("*")
    if params and params[-1].startswith("*"):
        return params[-1].lstrip("*")
    return None
