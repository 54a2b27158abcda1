"""ref-leak: ObjectRefs created but never returned, stored, passed on,
or released.

``fn.remote(...)`` and ``ray_tpu_torch.put(...)`` pin their result in the
owner's reference counter until the returned ref is consumed. Two
shapes leak the handle (the object can then never be freed, or —
worse — the caller can never observe the task's error):

- fire-and-forget: a bare ``something.remote(...)`` expression
  statement whose ref is dropped on the floor;
- dead local: ``x = something.remote(...)`` where ``x`` is never read
  again anywhere in the function.

Heuristic by design: a ref smuggled out via ``locals()``/``exec`` or
rebound through obscure aliasing is missed, and a deliberately
discarded ref should be written as ``_ = fn.remote(...)`` —
underscore-prefixed targets are exempt.
"""

from __future__ import annotations

import ast
from typing import List

from ray_tpu_torch.devtools.analysis.core import FileContext, Finding

PASS_ID = "ref-leak"
VERSION = 1


def _is_ref_producer(call: ast.Call) -> bool:
    fn = call.func
    if isinstance(fn, ast.Attribute):
        if fn.attr == "remote":
            return True
        if fn.attr == "put" and isinstance(fn.value, ast.Name) \
                and fn.value.id in ("ray_tpu_torch", "ray_tpu", "ray", "rt"):
            return True
    return False


class _FnChecker:
    def __init__(self, ctx: FileContext, fn: ast.AST,
                 findings: List[Finding]):
        self.ctx = ctx
        self.fn = fn
        self.findings = findings

    def run(self) -> None:
        loads = set()
        candidates = []     # (name, assign node)
        for node in ast.walk(self.fn):
            if isinstance(node, ast.Name) \
                    and isinstance(node.ctx, ast.Load):
                loads.add(node.id)
            elif isinstance(node, ast.Expr) \
                    and isinstance(node.value, ast.Call) \
                    and _is_ref_producer(node.value):
                self.findings.append(Finding(
                    PASS_ID, self.ctx.path, node.lineno,
                    self.ctx.scope_of(node),
                    "result ref of this .remote()/put() call is "
                    "discarded: the object (and any error) can never "
                    "be consumed — bind it, or assign to `_` to "
                    "discard deliberately"))
            elif isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and _is_ref_producer(node.value) \
                    and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                candidates.append((node.targets[0].id, node))
        for name, node in candidates:
            if name.startswith("_"):
                continue
            if name not in loads:
                self.findings.append(Finding(
                    PASS_ID, self.ctx.path, node.lineno,
                    self.ctx.scope_of(node),
                    f"ObjectRef bound to {name!r} is never read: the "
                    "ref leaks (never returned, stored, awaited or "
                    "released)"))


def check_file(ctx: FileContext) -> List[Finding]:
    # ast.walk visits nested defs from every enclosing function too;
    # dedupe so a finding inside a closure reports once.
    findings: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _FnChecker(ctx, node, findings).run()
    seen = set()
    out = []
    for f in findings:
        key = (f.path, f.line, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out
