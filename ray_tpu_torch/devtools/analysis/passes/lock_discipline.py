"""lock-discipline: every mutation of a ``# guarded-by:`` annotated
field must happen under ``with self.<lock>``.

Convention (see ray_tpu_torch/docs/static_analysis.md):

- Annotate the field where it is first assigned (usually ``__init__``)::

      self._running: Dict[TaskID, RunningTask] = {}  # guarded-by: _lock

- A method whose CALLERS hold the lock (a ``_locked`` helper) declares
  that on its ``def`` line (or the line directly above)::

      def _free_locked(self, oid):  # lock-held: _lock

The pass is lexical: entering ``with self.<lock>:`` (or any
``with <expr>.<lock>:``) marks the lock held for the statements inside.
Condition variables count — ``with self._cv:`` acquires ``_cv``'s
underlying lock. ``__init__``/``__del__`` are exempt (single-threaded
construction/teardown by convention). Reads are NOT checked; the pass
ratchets writer discipline only.

Known lexical approximations, accepted on purpose: a closure defined
inside a ``with`` block counts as guarded even though it may run later,
and ``self.lock.acquire()``/``release()`` pairs are invisible — use
``with`` (the repo already does everywhere).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional

from ray_tpu_torch.devtools.analysis.core import (FileContext, Finding,
                                             attr_tail)

PASS_ID = "lock-discipline"
VERSION = 2

_GUARDED_RE = re.compile(r"guarded-by:\s*(\w+)")
_HELD_RE = re.compile(r"lock-held:\s*(\w+)")
_SELF_FIELD_RE = re.compile(r"self\.(\w+)\s*[:=\[]")

# dict/list/set/deque/OrderedDict methods that mutate the receiver
_MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "insert",
    "pop", "popleft", "popitem", "remove", "clear", "update", "add",
    "discard", "setdefault", "move_to_end", "sort", "reverse",
}


def _self_field(node: ast.AST) -> Optional[str]:
    """``self.<field>`` -> field name (strictly on ``self``)."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _collect_guarded(ctx: FileContext, cls: ast.ClassDef
                     ) -> Dict[str, str]:
    """field -> lock name, from ``# guarded-by:`` comments on the
    class's ``self.<field> = ...`` lines."""
    guarded: Dict[str, str] = {}
    end = getattr(cls, "end_lineno", cls.lineno)
    for line_no in range(cls.lineno, end + 1):
        comment = ctx.comments.get(line_no)
        if not comment:
            continue
        m = _GUARDED_RE.search(comment)
        if not m:
            continue
        src = ctx.lines[line_no - 1]
        fm = _SELF_FIELD_RE.search(src)
        if fm:
            guarded[fm.group(1)] = m.group(1)
    return guarded


def _held_annotation(ctx: FileContext, fn: ast.AST) -> Optional[str]:
    """``# lock-held: <lock>`` on the def line or the line above."""
    for line_no in (fn.lineno, fn.lineno - 1):
        comment = ctx.comments.get(line_no)
        if comment:
            m = _HELD_RE.search(comment)
            if m:
                return m.group(1)
    return None


class _MethodChecker(ast.NodeVisitor):
    def __init__(self, ctx: FileContext, cls_name: str, fn_name: str,
                 guarded: Dict[str, str], held0: frozenset,
                 findings: List[Finding]):
        self.ctx = ctx
        self.cls_name = cls_name
        self.fn_name = fn_name
        self.guarded = guarded
        self.held = set(held0)
        self.findings = findings

    # -- lock tracking -----------------------------------------------------

    def visit_With(self, node) -> None:
        # ast.With and ast.AsyncWith share the items/body shape
        acquired = []
        for item in node.items:
            tail = attr_tail(item.context_expr)
            if tail is not None and tail not in self.held:
                acquired.append(tail)
                self.held.add(tail)
        for item in node.items:
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
            self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        for tail in acquired:
            self.held.discard(tail)

    visit_AsyncWith = visit_With   # `async with self._lock:` counts too

    # -- mutation detection ------------------------------------------------

    def _flag(self, node: ast.AST, field: str, how: str) -> None:
        lock = self.guarded[field]
        self.findings.append(Finding(
            PASS_ID, self.ctx.path, getattr(node, "lineno", 0),
            f"{self.cls_name}.{self.fn_name}",
            f"{how} of self.{field} outside `with self.{lock}` "
            f"(field is `# guarded-by: {lock}`)"))

    def _check_store_target(self, target: ast.AST) -> None:
        field = _self_field(target)
        if field is None and isinstance(target, ast.Subscript):
            field = _self_field(target.value)
        if field is None and isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._check_store_target(elt)
            return
        if field is not None and field in self.guarded \
                and self.guarded[field] not in self.held:
            self._flag(target, field, "write")

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._check_store_target(t)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._check_store_target(node.target)
            self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_store_target(node.target)
        self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._check_store_target(t)

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in _MUTATORS:
            field = _self_field(fn.value)
            if field is not None and field in self.guarded \
                    and self.guarded[field] not in self.held:
                self._flag(node, field, f".{fn.attr}()")
        self.generic_visit(node)


def check_file(ctx: FileContext) -> List[Finding]:
    findings: List[Finding] = []
    for cls in [n for n in ast.walk(ctx.tree)
                if isinstance(n, ast.ClassDef)]:
        guarded = _collect_guarded(ctx, cls)
        if not guarded:
            continue
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            if fn.name in ("__init__", "__del__"):
                continue
            held = _held_annotation(ctx, fn)
            checker = _MethodChecker(
                ctx, cls.name, fn.name, guarded,
                frozenset((held,)) if held else frozenset(), findings)
            for stmt in fn.body:
                checker.visit(stmt)
    return findings
