"""rpc-surface: cross-check server handler tables against client call
sites, so a client calling an unregistered method — or a renamed
handler orphaning its callers — fails lint instead of production.

Server side: every ``<server>.register("name", fn)`` with a literal
name (rpc.py's RpcServer surface; raylet_server.py, gcs_server.py,
worker.py's nested table, worker_core.py, object_transfer.py all
register this way). ``atexit.register`` is excluded by receiver name.

Client side: every ``.call("name", ...)``, ``.oneway("name", ...)`` or
``._call("name", ...)`` with a literal method name (RpcClient's surface
plus the GcsClient retry wrapper), and calls through wrapper functions
whose name ends with ``_call`` or ``_oneway`` (e.g. worker_core's
``_owner_call(addr, "owner_get", ...)``) — the method-name literal is
taken from the first string constant among the first two arguments.

Checks:

1. every client-called name has a registration somewhere in the
   scanned tree (the wire would answer "unknown method" at runtime);
2. every registered name has at least one static call site — a renamed
   or removed caller orphans the handler. Handlers invoked by external
   tooling only (CLI probes, foreign processes) mark the registration
   line with ``# rpc: external``.

Dynamic forwarding (``client.call(method, *args)`` with a variable
method) is invisible to this pass by design; the literal sites at the
wrapper's callers are what get checked.

Runtime introspection hooks pair with this: ``RpcServer.
registered_methods()`` (and ``GcsServer.rpc_methods()``) expose the
live table, and tests/test_static_analysis.py cross-checks the static
scan against a real server's registrations.

Since graftcheck v2 this is a phase-2 pass over the linked summary
cache (``check_graph``): registrations and call sites are collected
once per file by ``callgraph.summarize_file`` (cached on mtime/size),
so in ``--changed`` mode the cross-check still sees the WHOLE
program's surface, not just the edited files. ``_scan_file`` remains
the single-file scanner (the runtime-introspection test uses it
directly).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.devtools.analysis.core import (FileContext, Finding,
                                             attr_tail)

PASS_ID = "rpc-surface"
VERSION = 2

_CALL_METHODS = {"call", "oneway", "_call"}
_EXTERNAL_RE = re.compile(r"rpc:\s*external")


def _literal_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _scan_file(ctx: FileContext
               ) -> Tuple[Dict[str, List[Tuple[int, bool]]],
                          Dict[str, List[int]]]:
    """(registrations, call_sites) for one file: name -> [(line,
    external?)] and name -> [line]."""
    registrations: Dict[str, List[Tuple[int, bool]]] = {}
    calls: Dict[str, List[int]] = {}
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        fn = node.func
        fname = attr_tail(fn)
        if fname is None:
            continue
        if isinstance(fn, ast.Attribute) and fn.attr == "register":
            name = _literal_str(node.args[0])
            recv = attr_tail(fn.value)
            if name is None or recv == "atexit":
                continue
            comment = ctx.comments.get(node.lineno, "")
            external = bool(_EXTERNAL_RE.search(comment))
            registrations.setdefault(name, []).append(
                (node.lineno, external))
        elif fname in _CALL_METHODS or fname.endswith("_call") \
                or fname.endswith("_oneway"):
            # direct client surface, or a wrapper function forwarding
            # a method name (first string literal of the leading args);
            # deliberately NOT a substring match — `callback("x", ...)`
            # must not be read as an RPC call site
            for arg in node.args[:2]:
                name = _literal_str(arg)
                if name is not None:
                    calls.setdefault(name, []).append(node.lineno)
                    break
    return registrations, calls


def check_graph(graph) -> List[Finding]:
    # (path, line, scope[, external]) sites from the linked summaries
    registered: Dict[str, List[Tuple[str, int, str, bool]]] = {}
    called: Dict[str, List[Tuple[str, int, str]]] = {}
    for path, s in graph.summaries.items():
        for name, line, external, _target, scope in s.get("rpc_regs",
                                                          []):
            registered.setdefault(name, []).append(
                (path, line, scope, external))
        for name, line, scope in s.get("rpc_calls", []):
            called.setdefault(name, []).append((path, line, scope))

    findings: List[Finding] = []
    if not registered:
        # Scanning a slice of the tree with no server files: the
        # cross-check would flag every call site; stay silent instead
        # of lying.
        return findings
    for name, csites in sorted(called.items()):
        if name in registered:
            continue
        for path, line, scope in csites:
            findings.append(Finding(
                PASS_ID, path, line, scope,
                f"client calls RPC method {name!r} but no server "
                f"registers it"))
    for name, rsites in sorted(registered.items()):
        if name in called:
            continue
        for path, line, scope, external in rsites:
            if external:
                continue
            findings.append(Finding(
                PASS_ID, path, line, scope,
                f"handler {name!r} is registered but never called "
                "from any scanned client site (renamed caller? mark "
                "`# rpc: external` if invoked from outside)"))
    return findings
