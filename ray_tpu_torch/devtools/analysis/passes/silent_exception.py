"""silent-exception: flag broad except-blocks that swallow without
logging, re-raising, or saying why.

A distributed runtime's worst bugs hide behind ``except Exception:
pass`` — a completion callback dies and a task hangs forever with no
trace. Narrow catches (``except OSError: pass`` around a close) are
idiomatic cleanup and exempt. A broad catch (bare ``except``,
``Exception``, ``BaseException``) is flagged when ALL of:

- the handler body is pure ``pass``/``...`` (nothing logged, raised,
  returned, assigned, or called), and
- no comment documents the swallow — a ``#`` comment anywhere on the
  handler's lines (including the ``except`` line itself) marks it
  intentional.

The fix is one of: narrow the exception type, log it, re-raise, or
write the one-line comment saying why dropping it is safe.
"""

from __future__ import annotations

import ast
from typing import List

from ray_tpu_torch.devtools.analysis.core import FileContext, Finding

PASS_ID = "silent-exception"
VERSION = 1

_BROAD = {"Exception", "BaseException"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = t.elts if isinstance(t, ast.Tuple) else [t]
    for n in names:
        if isinstance(n, ast.Name) and n.id in _BROAD:
            return True
        if isinstance(n, ast.Attribute) and n.attr in _BROAD:
            return True
    return False


def _is_pure_swallow(handler: ast.ExceptHandler) -> bool:
    for stmt in handler.body:
        if isinstance(stmt, ast.Pass):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value,
                                                     ast.Constant):
            continue        # docstring / Ellipsis
        return False
    return True


def _has_comment(ctx: FileContext, handler: ast.ExceptHandler) -> bool:
    end = getattr(handler, "end_lineno", handler.lineno)
    return any(line in ctx.comments
               for line in range(handler.lineno, end + 1))


def check_file(ctx: FileContext) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not (_is_broad(node) and _is_pure_swallow(node)):
            continue
        if _has_comment(ctx, node):
            continue
        findings.append(Finding(
            PASS_ID, ctx.path, node.lineno, ctx.scope_of(node),
            "broad except swallows silently: narrow the type, log, "
            "re-raise, or add a comment saying why dropping it is "
            "safe"))
    return findings
