"""deadline-discipline: sleep-poll loops in the runtime core must
consult a deadline or justify why not.

A ``while ...: ... time.sleep(...)`` loop that never looks at a clock
is an unbounded wait wearing a polling costume: when the condition it
polls for can no longer become true (dead peer, aborted gang, wedged
child), the thread spins forever. The collective plane's ``_wait_load``
hang — every surviving rank burning the full group timeout on a dead
member — is the motivating instance: liveness-aware loops need a
deadline (or an abort signal) consulted *inside* the loop. The rule is
structural: inside ``ray_tpu_torch/_private/`` and ``ray_tpu_torch/collective/``,
every ``while`` loop whose body calls ``time.sleep`` must either

- consult a clock — a call to ``time.monotonic()`` / ``time.time()``
  anywhere in the loop's condition or body (comparing against a
  deadline, computing a remaining budget, ...), or
- carry a ``# no-deadline: <why>`` comment naming what actually bounds
  the loop (a shutdown flag on a daemon service loop, an outer
  deadline, ...) — on the ``while`` line, on the sleep call's line, or
  in the contiguous comment block directly above the loop.

``Event.wait(timeout)``-style loops are out of scope (the wait itself
carries the bound); only bare ``sleep`` polling is checked. Nested
function definitions inside a loop body are skipped — their sleeps
belong to the scope that eventually runs them.
"""

from __future__ import annotations

import ast
from typing import List

from ray_tpu_torch.devtools.analysis.core import FileContext, Finding, attr_tail

PASS_ID = "deadline-discipline"
VERSION = 7   # v7: cluster autoscaler (ray_tpu_torch/autoscaler/)

_SCOPES = ("_private/", "collective/", "multislice/",
           "serve/", "data/", "autoscaler/", "analysis_fixtures/")

_SUPPRESS_MARK = "no-deadline:"

_CLOCKS = ("monotonic", "time", "perf_counter")


def _iter_loop_nodes(loop: ast.While):
    """Walk the loop's test + body, skipping nested function/class
    definitions (their bodies run in another scope/time)."""
    stack: List[ast.AST] = [loop.test, *loop.body]
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _sleep_calls(loop: ast.While) -> List[ast.Call]:
    out = []
    for node in _iter_loop_nodes(loop):
        if isinstance(node, ast.Call) and attr_tail(node.func) == "sleep":
            # time.sleep / bare sleep — not obj.event.wait etc.
            fn = node.func
            if isinstance(fn, ast.Name) or (
                    isinstance(fn, ast.Attribute)
                    and attr_tail(fn.value) == "time"):
                out.append(node)
    return out


def _consults_clock(loop: ast.While) -> bool:
    for node in _iter_loop_nodes(loop):
        if isinstance(node, ast.Call) and attr_tail(node.func) in _CLOCKS:
            fn = node.func
            # time.monotonic() / time.time(), or the from-import bare
            # forms (monotonic(), time(), perf_counter()) — the same
            # spellings _sleep_calls accepts for the sleep itself
            if isinstance(fn, ast.Name) or (
                    isinstance(fn, ast.Attribute)
                    and attr_tail(fn.value) == "time"):
                return True
    return False


def _suppressed(ctx: FileContext, loop: ast.While,
                sleeps: List[ast.Call]) -> bool:
    lines = {loop.lineno}
    for call in sleeps:
        end = getattr(call, "end_lineno", call.lineno)
        lines.update(range(call.lineno, end + 1))
    for line in lines:
        comment = ctx.comments.get(line)
        if comment and _SUPPRESS_MARK in comment:
            return True
    # contiguous comment-only block directly above the while
    line = loop.lineno - 1
    while line > 0 and line in ctx.comments:
        if not ctx.lines[line - 1].lstrip().startswith("#"):
            break
        if _SUPPRESS_MARK in ctx.comments[line]:
            return True
        line -= 1
    return False


def check_file(ctx: FileContext) -> List[Finding]:
    if not any(scope in ctx.path for scope in _SCOPES):
        return []
    findings: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.While):
            continue
        sleeps = _sleep_calls(node)
        if not sleeps:
            continue
        if _consults_clock(node):
            continue
        if _suppressed(ctx, node, sleeps):
            continue
        findings.append(Finding(
            PASS_ID, ctx.path, node.lineno, ctx.scope_of(node),
            "sleep-poll loop never consults a clock: when the polled "
            "condition can no longer become true, this thread spins "
            "forever — check time.monotonic() against a deadline (or "
            "an abort signal) inside the loop, or annotate "
            "`# no-deadline: <what bounds it>`"))
    return findings
