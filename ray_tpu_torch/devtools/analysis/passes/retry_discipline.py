"""retry-discipline: RPC call sites in the runtime core must carry a
deadline.

A ``client.call("method", ...)`` without ``timeout=`` blocks its
thread for as long as the peer cares to stall — and in a distributed
runtime, a peer WILL stall (dying raylet, GC-paused GCS, severed
network). Every such hang found so far traced back to a deadline-less
call site, so the rule is structural: inside ``ray_tpu_torch/_private/``,
every ``.call(...)`` whose method is a string literal must either

- pass ``timeout=`` (or forward ``**kwargs`` that may carry one), or
- carry a ``# no-deadline: <why>`` comment on the call's lines for
  sites that MUST block indefinitely by design (e.g. the nested
  worker protocol's get/wait, which return only when an object
  exists).

Wrapper calls whose method is a variable (``self._client.call(method,
...)``) are the wrapper's problem — the wrapper's own literal sites
are checked. Only ``_private/`` and ``collective/`` (and the lint
fixtures) are in scope: the library layers talk through
already-deadlined seams.
"""

from __future__ import annotations

import ast
from typing import List

from ray_tpu_torch.devtools.analysis.core import FileContext, Finding

PASS_ID = "retry-discipline"
VERSION = 8   # v8: cluster autoscaler (ray_tpu_torch/autoscaler/)

# Enforced scopes: the runtime core, the collective/gang plane, plus
# the lint fixture tree (the self-test floor in
# tests/analysis_fixtures/).
_SCOPES = ("_private/", "collective/", "multislice/",
           "serve/", "data/", "autoscaler/", "analysis_fixtures/")

_SUPPRESS_MARK = "no-deadline:"


def _suppressed(ctx: FileContext, node: ast.Call) -> bool:
    end = getattr(node, "end_lineno", node.lineno)
    for line in range(node.lineno, end + 1):
        comment = ctx.comments.get(line)
        if comment and _SUPPRESS_MARK in comment:
            return True
    return False


def check_file(ctx: FileContext) -> List[Finding]:
    if not any(scope in ctx.path for scope in _SCOPES):
        return []
    findings: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not (isinstance(fn, ast.Attribute) and fn.attr == "call"):
            continue
        if not node.args:
            continue
        first = node.args[0]
        if not (isinstance(first, ast.Constant)
                and isinstance(first.value, str)):
            continue            # variable method: a wrapper's seam
        if any(kw.arg == "timeout" for kw in node.keywords):
            continue
        if any(kw.arg is None for kw in node.keywords):
            continue            # **kwargs may forward a timeout
        if _suppressed(ctx, node):
            continue
        findings.append(Finding(
            PASS_ID, ctx.path, node.lineno, ctx.scope_of(node),
            f"rpc call {first.value!r} has no timeout=: a stalled peer "
            "pins this thread forever — pass a deadline or annotate "
            "`# no-deadline: <why>`"))
    return findings
