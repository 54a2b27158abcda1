"""async-blocking: flag blocking calls inside ``async def`` bodies.

An event loop runs every coroutine of an async actor (and the serve
proxy/router) on ONE thread; any synchronous block stalls all of them
— the classic "async actor froze under load" incident. Flagged:

- ``time.sleep(...)`` (aliased module names ending in ``time`` count;
  ``await asyncio.sleep`` is the fix)
- blocking pipe/socket reads: ``.recv()``, ``.recv_bytes()``,
  ``.accept()``, ``.readinto()``
- synchronous RPC round-trips: ``.call(...)`` on anything whose name
  (or final attribute) contains ``client`` — RpcClient.call parks the
  calling thread on a queue until the reply frame lands
- ``.result()`` / blocking ``.get(...)`` / ``.wait(...)`` on futures,
  queues and events when the receiver name makes that clear
  (``*queue*``, ``*event*``, ``*future*``)

Nested ``def``s inside an async function are skipped (they execute
wherever they are called, commonly shipped to an executor); nested
``async def``s are checked on their own.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ray_tpu_torch.devtools.analysis.core import (FileContext, Finding,
                                             attr_tail)

PASS_ID = "async-blocking"
VERSION = 1

_BLOCKING_READ_ATTRS = {"recv", "recv_bytes", "accept", "readinto"}
_RECEIVER_HINT_ATTRS = {"get": ("queue",),
                        "wait": ("queue", "event", "evt"),
                        "result": ("future", "fut")}


def _is_time_module(node: ast.AST) -> bool:
    name = attr_tail(node)
    return name is not None and (name == "time" or name.endswith("time"))


class _AsyncBodyChecker(ast.NodeVisitor):
    def __init__(self, ctx: FileContext, scope: str,
                 findings: List[Finding]):
        self.ctx = ctx
        self.scope = scope
        self.findings = findings

    def _flag(self, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            PASS_ID, self.ctx.path, getattr(node, "lineno", 0),
            self.scope, message))

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass            # sync helper: runs where it is called

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        pass            # checked as its own scope by check_file

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            recv = fn.value
            if fn.attr == "sleep" and _is_time_module(recv):
                self._flag(node, "time.sleep() blocks the event loop; "
                                 "use `await asyncio.sleep(...)`")
            elif fn.attr in _BLOCKING_READ_ATTRS:
                self._flag(node, f".{fn.attr}() is a blocking read "
                                 "inside an async function")
            elif fn.attr == "call":
                name = (attr_tail(recv) or "").lower()
                if "client" in name:
                    self._flag(node, "synchronous RPC .call() blocks "
                                     "the event loop; run it in an "
                                     "executor")
            elif fn.attr in _RECEIVER_HINT_ATTRS:
                name = (attr_tail(recv) or "").lower()
                if any(h in name for h in _RECEIVER_HINT_ATTRS[fn.attr]):
                    self._flag(node, f".{fn.attr}() on {name!r} blocks "
                                     "inside an async function")
        self.generic_visit(node)


def check_file(ctx: FileContext) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.AsyncFunctionDef):
            checker = _AsyncBodyChecker(ctx, ctx.scope_of(node),
                                        findings)
            for stmt in node.body:
                checker.visit(stmt)
    return findings
