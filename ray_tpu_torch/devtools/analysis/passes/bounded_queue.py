"""bounded-queue: queue constructions in the runtime core must be
bounded or justify why not.

An unbounded ``Queue()`` / ``deque()`` in a distributed runtime is a
latent OOM: every overload incident traces back to some intake that
"can't" grow without limit growing without limit (the motivation for
the raylet's bounded scheduler intake). The rule is structural: inside
``ray_tpu_torch/_private/``, every construction of ``queue.Queue`` /
``LifoQueue`` / ``PriorityQueue`` / ``SimpleQueue`` /
``collections.deque`` must either

- pass a bound (``maxsize=`` / ``maxlen=``, keyword or positional), or
- carry a ``# unbounded-ok: <why>`` comment naming the mechanism that
  actually bounds it (admission control upstream, a drain thread, a
  protocol cap, ...) — on the construction's lines, or in the
  contiguous comment block directly above it (reasons are sentences;
  they don't fit end-of-line).

Only ``_private/`` and ``collective/`` (and the lint fixtures) are in
scope; library layers buffer user data under user-visible knobs.
"""

from __future__ import annotations

import ast
from typing import List

from ray_tpu_torch.devtools.analysis.core import (FileContext, Finding,
                                            attr_tail,
                                            suppressed_by_mark)

PASS_ID = "bounded-queue"
VERSION = 9   # v9: cluster autoscaler (ray_tpu_torch/autoscaler/)

_SCOPES = ("_private/", "collective/", "multislice/",
           "serve/", "data/", "autoscaler/", "analysis_fixtures/")

_SUPPRESS_MARK = "unbounded-ok:"

# constructor name -> (bound keyword, positional index of the bound)
_QUEUE_CTORS = {
    "Queue": ("maxsize", 0),
    "LifoQueue": ("maxsize", 0),
    "PriorityQueue": ("maxsize", 0),
    "deque": ("maxlen", 1),
    # SimpleQueue has no bound parameter at all: always flagged unless
    # annotated.
    "SimpleQueue": (None, None),
}


def _unbounded_literal(name: str, value: ast.AST) -> bool:
    """A literal bound that stdlib semantics define as INFINITE:
    ``None`` always; for the Queue family also ``maxsize <= 0``
    (``deque(maxlen=0)`` really is bounded — at zero)."""
    if isinstance(value, ast.UnaryOp) and isinstance(value.op, ast.USub) \
            and isinstance(value.operand, ast.Constant) \
            and isinstance(value.operand.value, int):
        return name != "deque"          # negative maxsize = infinite
    if not isinstance(value, ast.Constant):
        return False
    if value.value is None:
        return True
    return (name != "deque" and isinstance(value.value, int)
            and not isinstance(value.value, bool) and value.value <= 0)


def _is_bounded(name: str, node: ast.Call, bound_kw, bound_pos) -> bool:
    if bound_kw is None:
        return False
    for kw in node.keywords:
        if kw.arg == bound_kw:
            # spelled-out unboundedness (None, or maxsize<=0 — the
            # stdlib's "infinite" spellings) needs the annotation too
            return not _unbounded_literal(name, kw.value)
        if kw.arg is None:
            return True     # **kwargs may carry the bound
    if len(node.args) > bound_pos:
        return not _unbounded_literal(name, node.args[bound_pos])
    return False


def check_file(ctx: FileContext) -> List[Finding]:
    if not any(scope in ctx.path for scope in _SCOPES):
        return []
    findings: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = attr_tail(node.func)
        if name not in _QUEUE_CTORS:
            continue
        bound_kw, bound_pos = _QUEUE_CTORS[name]
        if _is_bounded(name, node, bound_kw, bound_pos):
            continue
        if suppressed_by_mark(ctx, node, _SUPPRESS_MARK):
            continue
        hint = (f"pass {bound_kw}=" if bound_kw
                else "use a bounded queue type")
        findings.append(Finding(
            PASS_ID, ctx.path, node.lineno, ctx.scope_of(node),
            f"unbounded {name}() construction: every unbounded intake "
            f"is a latent OOM under overload — {hint} or annotate "
            "`# unbounded-ok: <what actually bounds it>`"))
    return findings
