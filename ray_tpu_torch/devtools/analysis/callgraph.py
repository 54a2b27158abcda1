"""graftcheck phase 1/phase 2 infrastructure: per-file summaries and
the whole-program link (graftcheck v2).

The per-file passes catch what a single AST shows; the three bug
classes reviewers kept catching by hand — lock-order inversions,
blocking work performed while holding a lock, tuple-only type gates on
values that crossed the RTF1 fastframe as msgpack lists — are all
*interprocedural*: the evidence spans a caller in one file and a
callee in another. This module makes them machine-checkable in two
phases:

- **Phase 1** (``summarize_file``): one extra AST walk per file
  produces a JSON-serializable summary — function defs, call edges
  (with held-lock context and lock-valued arguments), lock
  acquisitions (``with self._x_lock:``, ``.acquire()``), blocking-call
  sites, tuple-only type gates, ``# lock-order:`` declarations, RPC
  registrations/call sites, and the ``_FASTFRAME_SAFE`` literal.
  Summaries are cached per file next to the per-file findings (same
  mtime/size key), so a warm run never re-parses an unchanged file.

- **Phase 2** (``ProjectGraph``): links every summary into a project
  call graph and exposes the queries the whole-program passes need —
  call resolution (receiver-aware, ambiguity-capped), lock-node
  resolution (class-qualified, so ``NodeManagerGroup._lock`` and
  ``DependencyManager._lock`` stay distinct), transitive
  lock-acquisition closures (including locks passed as *parameters*,
  the ``_send_frame(sock, obj, lock)`` pattern), transitive
  blocking-site closures, and parameter-taint propagation for the
  wire-shape pass. Phase 2 always re-runs: a cross-file finding whose
  evidence spans files A and B is recomputed from the freshest
  summaries, so editing A invalidates it even when B is cache-hit.

Identity model for locks: a lock is ``(owner, name)`` where owner is
the class that *defines* it (``self._x_lock = threading.Lock()``) or
the module path for module-level locks. Acquisitions through non-self
receivers (``ctx._send_lock``) resolve through the defining classes;
a name defined by more than two classes is too ambiguous to attribute
and produces no edge (precision over recall — this suite must stay
zero-false-positive to live in tier-1). ``threading.Condition(self._x)``
is recorded as an *alias* of ``_x``: acquiring the condition acquires
the underlying lock, so condition variables can never fabricate a
second node for the same mutex.
"""

from __future__ import annotations

import ast
import builtins as _builtins
import re
from typing import Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.devtools.analysis.core import (FileContext, attr_tail,
                                             suppressed_by_mark)

# Bump to invalidate every cached summary (core folds this into the
# cache version tag alongside the per-pass versions).
SUMMARY_VERSION = 4

# A with-item / lock-arg is considered lock-like when its defining
# class marks it as a lock, or (fallback for files whose __init__ was
# not scanned) when its name says so.
_LOCKISH_RE = re.compile(r"lock|_cv$|_cond", re.IGNORECASE)

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}

_LOCK_ORDER_RE = re.compile(r"lock-order:\s*([\w.]+(?:\s*->\s*[\w.]+)*)")
_HELD_RE = re.compile(r"lock-held:\s*(\w+)")
_EXTERNAL_RE = re.compile(r"rpc:\s*external")
_GUARDED_RE = re.compile(r"guarded-by:\s*(\w+)")
_BLOCKING_OK_RE = re.compile(r"blocking-ok:\s*(.*)")
# Field the annotation binds to: `self.<field> = ...` inside a class,
# `<name> = ...` at column 0 for module-level state (same shapes the
# lock-discipline pass recognizes).
_SELF_FIELD_RE = re.compile(r"self\.(\w+)\s*[:=\[]")
_MODULE_FIELD_RE = re.compile(r"^(\w+)\s*[:=\[]")

_CHAOS_METHODS = {"fire", "fire_arg", "fire_site"}

_CHAOS_UNREACHABLE_MARK = "chaos-unreachable:"
_SWALLOW_OK_MARK = "swallow-ok:"

# Metric declarations/uses: constructor calls of the util.metrics
# family whose first argument is a string literal. These are the only
# places a `ray_tpu_*` series name is load-bearing in code — scrape
# emission always goes through the constructed objects.
_METRIC_CTORS = {"Gauge", "Counter", "Histogram"}

# The ingress HTTP error table literal (error-flow pass): a
# module-level `{<taxonomy class name>: <status int>}` assignment
# under this name is the machine-checked boundary mapping.
_HTTP_TABLE_NAME = "_HTTP_STATUS_BY_TAXONOMY"

# Exception-class summary filter: record structure only for classes
# that look like exception taxonomy members (name or a base mentions
# Error/Exception) — everything the error-flow pass can ever care
# about, without bloating every file's summary.
_EXCISH_RE = re.compile(r"(Error|Exception)$")

_BLOCKING_OK_MARK = "blocking-ok:"
_WIRE_OK_MARK = "wire-shape-ok:"
_LOCK_ORDER_OK_MARK = "lock-order-ok:"

_RPC_CALL_METHODS = {"call", "oneway", "_call"}


def _literal_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _str_shape(node: Optional[ast.AST]) -> str:
    """Best static rendering of a string-valued chaos-event argument:
    a literal gives itself, an f-string gives its leading constant
    prefix + ``*`` (``f"save_{tag}"`` -> ``save_*``), anything else
    (or a missing arg) is fully dynamic."""
    if node is None:
        return ""
    lit = _literal_str(node)
    if lit is not None:
        return lit
    if isinstance(node, ast.JoinedStr) and node.values:
        first = node.values[0]
        prefix = _literal_str(first)
        if prefix:
            return prefix + "*"
    return "*"


def _root_name(node: ast.AST) -> Optional[str]:
    """Base Name of a Name/Subscript/Attribute/Starred chain:
    ``msg[0].kind`` -> ``msg``."""
    while isinstance(node, (ast.Subscript, ast.Attribute, ast.Starred)):
        node = node.value if not isinstance(node, ast.Starred) \
            else node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def _lockspec(node: ast.AST) -> Optional[list]:
    """Encode a lock-valued expression for the summary:
    ``["self", X]`` / ``["attr", recv, X]`` / ``["name", N]``."""
    if isinstance(node, ast.Attribute):
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            return ["self", node.attr]
        recv = attr_tail(node.value)
        return ["attr", recv or "", node.attr]
    if isinstance(node, ast.Name):
        return ["name", node.id]
    return None


def _is_time_receiver(node: ast.AST) -> bool:
    name = attr_tail(node)
    return name is not None and (name == "time" or name.endswith("time"))


class _FnSummarizer(ast.NodeVisitor):
    """One function body -> events list (acquisitions, calls, blocking
    sites) with the lexical held-lock stack snapshot at each event,
    plus tuple-only type gates."""

    def __init__(self, ctx: FileContext, cls: Optional[str],
                 held0: List[list]):
        self.ctx = ctx
        self.cls = cls
        self.held: List[list] = list(held0)
        self.events: List[list] = []
        self.gates: List[list] = []
        # `# blocking-ok:` annotated site line spans — the sanitizer's
        # runtime probes skip a blocking call whose caller frame lands
        # inside one of these (graftsan manifest `blocking_escapes`).
        self.escapes: List[list] = []

    # -- helpers -------------------------------------------------------

    def _ok(self, node: ast.AST, mark: str) -> bool:
        return suppressed_by_mark(self.ctx, node, mark)

    def _event(self, kind: str, payload: list, node: ast.AST) -> None:
        self.events.append([kind] + payload
                           + [getattr(node, "lineno", 0),
                              [list(h) for h in self.held]])

    # -- scope boundaries ----------------------------------------------

    def visit_FunctionDef(self, node) -> None:
        pass        # nested defs are summarized as their own scope

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_ClassDef = visit_FunctionDef

    # -- lock tracking -------------------------------------------------

    def visit_With(self, node) -> None:
        acquired = []
        for item in node.items:
            spec = _lockspec(item.context_expr)
            if spec is not None and spec not in self.held:
                if not self._ok(node, _LOCK_ORDER_OK_MARK):
                    self._event("acq", [spec], node)
                acquired.append(spec)
                self.held.append(spec)
        for item in node.items:
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
            self.visit(item.context_expr)
        self._visit_block(node.body)
        for spec in acquired:
            self.held.remove(spec)

    visit_AsyncWith = visit_With

    def _visit_block(self, stmts: Sequence[ast.stmt]) -> None:
        """Statement-list walk handling bare ``x.acquire()`` /
        ``x.release()`` pairs: an acquire holds for the remaining
        statements of its block (or until the matching release)."""
        acquired: List[list] = []
        for stmt in stmts:
            spec = self._bare_lock_stmt(stmt, "acquire")
            if spec is not None and spec not in self.held:
                if not self._ok(stmt, _LOCK_ORDER_OK_MARK):
                    self._event("acq", [spec], stmt)
                acquired.append(spec)
                self.held.append(spec)
                continue
            rel = self._bare_lock_stmt(stmt, "release")
            if rel is not None and rel in acquired:
                acquired.remove(rel)
                self.held.remove(rel)
                continue
            self.visit(stmt)
        for spec in acquired:
            self.held.remove(spec)

    @staticmethod
    def _bare_lock_stmt(stmt: ast.stmt, verb: str) -> Optional[list]:
        if (isinstance(stmt, ast.Expr)
                and isinstance(stmt.value, ast.Call)
                and isinstance(stmt.value.func, ast.Attribute)
                and stmt.value.func.attr == verb
                and not stmt.value.args and not stmt.value.keywords):
            return _lockspec(stmt.value.func.value)
        return None

    # Route every statement-list through _visit_block so acquire()
    # tracking sees siblings. generic_visit walks fields; we override
    # the common block-bearing nodes.
    def visit_If(self, node) -> None:
        self.visit(node.test)
        self._visit_block(node.body)
        self._visit_block(node.orelse)

    def visit_For(self, node) -> None:
        self.visit(node.target)
        self.visit(node.iter)
        self._visit_block(node.body)
        self._visit_block(node.orelse)

    visit_AsyncFor = visit_For

    def visit_While(self, node) -> None:
        self.visit(node.test)
        self._visit_block(node.body)
        self._visit_block(node.orelse)

    def visit_Try(self, node) -> None:
        self._visit_block(node.body)
        for h in node.handlers:
            self._visit_block(h.body)
        self._visit_block(node.orelse)
        self._visit_block(node.finalbody)

    # -- calls / blocking sites ----------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        tail = attr_tail(fn)
        recv = attr_tail(fn.value) if isinstance(fn, ast.Attribute) \
            else None
        blocked = self._classify_blocking(node, fn, tail, recv)
        if blocked is not None:
            kind, desc = blocked
            ok = self._ok(node, _BLOCKING_OK_MARK)
            if ok:
                self.escapes.append(
                    [node.lineno,
                     getattr(node, "end_lineno", node.lineno)])
            self._event("block", [kind, desc, ok], node)
        if tail is not None and blocked is None:
            lock_args: Dict[str, list] = {}
            derived: Dict[str, List[str]] = {}
            for i, arg in enumerate(node.args):
                spec = _lockspec(arg)
                if spec is not None:
                    lock_args[str(i)] = spec
                root = _root_name(arg)
                if root is not None:
                    derived[str(i)] = [root]
            for kw in node.keywords:
                if kw.arg is None:
                    continue
                spec = _lockspec(kw.value)
                if spec is not None:
                    lock_args["k:" + kw.arg] = spec
            ok = self._ok(node, _BLOCKING_OK_MARK)
            if ok:
                self.escapes.append(
                    [node.lineno,
                     getattr(node, "end_lineno", node.lineno)])
            self._event("call",
                        [tail, recv or "",
                         {"lock_args": lock_args, "args": derived,
                          "ok": ok}],
                        node)
        # type(x) is tuple gates live in Compare, handled below; here
        # catch isinstance(...)
        if (isinstance(fn, ast.Name) and fn.id == "isinstance"
                and len(node.args) == 2):
            self._gate_from_isinstance(node)
        self.generic_visit(node)

    def _classify_blocking(self, node: ast.Call, fn: ast.AST,
                           tail: Optional[str], recv: Optional[str]
                           ) -> Optional[Tuple[str, str]]:
        if tail is None:
            return None
        if recv == "subprocess":
            return ("subprocess", f"subprocess.{tail}(...)")
        if isinstance(fn, ast.Attribute):
            if tail == "sleep" and _is_time_receiver(fn.value):
                return ("sleep", "time.sleep(...)")
            if tail in _RPC_CALL_METHODS:
                method = _literal_str(node.args[0]) if node.args else None
                label = f".{tail}({method!r})" if method else f".{tail}(...)"
                return ("rpc", label + " (synchronous RPC round trip)")
            if recv == "durable":
                return ("durable", f"durable.{tail}(...) (fsync'd "
                                   "file write)")
            if tail == "get":
                # Only the Queue.get(block=..., timeout=...) shape:
                # a bare .get() is overwhelmingly dict.get, and a
                # receiver-name heuristic misfires on dicts OF queues
                # (`self._actor_queues.get(aid)`).
                kwargs = {kw.arg for kw in node.keywords}
                if "block" in kwargs or "timeout" in kwargs:
                    return ("queue-get", f".get(block=/timeout=) on "
                                         f"{recv!r} (blocking dequeue)")
        elif isinstance(fn, ast.Name):
            if fn.id == "sleep":
                return ("sleep", "sleep(...)")
            if fn.id == "open":
                mode = None
                if len(node.args) >= 2:
                    mode = _literal_str(node.args[1])
                for kw in node.keywords:
                    if kw.arg == "mode":
                        mode = _literal_str(kw.value)
                if mode and any(c in mode for c in "wax+"):
                    return ("file-write", f"open(..., {mode!r})")
        return None

    # -- wire-shape gates ----------------------------------------------

    def _gate_from_isinstance(self, node: ast.Call) -> None:
        root = _root_name(node.args[0])
        if root is None:
            return
        types = node.args[1]
        names = set()
        if isinstance(types, ast.Name):
            names = {types.id}
        elif isinstance(types, ast.Tuple):
            names = {e.id for e in types.elts if isinstance(e, ast.Name)}
        if "tuple" in names and "list" not in names:
            self.gates.append([node.lineno, root,
                               "isinstance(..., tuple)",
                               self._ok(node, _WIRE_OK_MARK)])

    def visit_Compare(self, node: ast.Compare) -> None:
        # type(x) is tuple  /  type(x) == tuple
        left, ops, rights = node.left, node.ops, node.comparators
        if (isinstance(left, ast.Call) and isinstance(left.func, ast.Name)
                and left.func.id == "type" and len(left.args) == 1
                and len(rights) == 1
                and isinstance(ops[0], (ast.Is, ast.Eq))
                and isinstance(rights[0], ast.Name)
                and rights[0].id == "tuple"):
            root = _root_name(left.args[0])
            if root is not None:
                self.gates.append([node.lineno, root, "type(...) is tuple",
                                   self._ok(node, _WIRE_OK_MARK)])
        self.generic_visit(node)

    def visit_Match(self, node) -> None:
        # `case tuple(...)` class patterns reject msgpack lists; plain
        # sequence patterns match both and are fine.
        root = _root_name(node.subject)
        for case in node.cases:
            for pat in ast.walk(case.pattern):
                if (isinstance(pat, ast.MatchClass)
                        and isinstance(pat.cls, ast.Name)
                        and pat.cls.id == "tuple" and root is not None):
                    self.gates.append([pat.lineno, root,
                                       "match case tuple(...)",
                                       self._ok(pat, _WIRE_OK_MARK)])
        self.generic_visit(node)


def _held_annotation(ctx: FileContext, fn: ast.AST) -> List[str]:
    out = []
    for line_no in (fn.lineno, fn.lineno - 1):
        comment = ctx.comments.get(line_no)
        if comment:
            m = _HELD_RE.search(comment)
            if m:
                out.append(m.group(1))
    return out


def _collect_taint_flow(fn: ast.AST) -> Dict[str, List[str]]:
    """param-derivation map for the function's locals: which params a
    local (transitively) derives from via copies, subscripts, unpacks,
    ``list()``/``tuple()`` wrapping, and for-loop targets. Single
    forward pass in source order — enough for real handler bodies."""
    params = [a.arg for a in fn.args.args + fn.args.posonlyargs
              + fn.args.kwonlyargs]
    if fn.args.vararg is not None:
        params.append(fn.args.vararg.arg)
    derives: Dict[str, set] = {p: {p} for p in params}

    def sources(value: ast.AST) -> set:
        if isinstance(value, (ast.Subscript, ast.Attribute, ast.Starred,
                              ast.Name)):
            root = _root_name(value)
            return set(derives.get(root, ()))
        if isinstance(value, ast.Call) \
                and isinstance(value.func, ast.Name) \
                and value.func.id in ("list", "tuple") and value.args:
            return sources(value.args[0])
        if isinstance(value, (ast.Tuple, ast.List)):
            out: set = set()
            for e in value.elts:
                out |= sources(e)
            return out
        return set()

    def bind(target: ast.AST, src: set) -> None:
        if isinstance(target, ast.Name):
            if src:
                derives.setdefault(target.id, set()).update(src)
            else:
                derives.pop(target.id, None)   # overwritten: taint ends
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                bind(e, src)
        elif isinstance(target, ast.Starred):
            bind(target.value, src)

    # ast.walk is breadth-first; binding in that order would apply a
    # later top-level overwrite BEFORE an earlier nested assignment
    # and resurrect dead taint (a false positive the suite can't
    # afford). Sort the binding sites by source position instead —
    # the forward pass the docstring promises.
    sites = [n for n in ast.walk(fn)
             if isinstance(n, (ast.Assign, ast.AnnAssign, ast.For,
                               ast.AsyncFor))]
    sites.sort(key=lambda n: (n.lineno, n.col_offset))
    for node in sites:
        if isinstance(node, ast.Assign):
            src = sources(node.value)
            for t in node.targets:
                bind(t, src)
        elif isinstance(node, ast.AnnAssign):
            if node.value is not None:
                bind(node.target, sources(node.value))
        else:
            bind(node.target, sources(node.iter))
    return {k: sorted(v) for k, v in derives.items()}


def summarize_file(ctx: FileContext) -> dict:
    """Phase-1 summary of one file (JSON-serializable, cached)."""
    classes: Dict[str, dict] = {}
    functions: Dict[str, dict] = {}

    def _def_escape(line_no: int) -> Optional[str]:
        """`# blocking-ok: <why>` on a lock DEFINITION line escapes the
        lock itself at runtime: graftsan's blocking probes ignore it
        (e.g. ``_send_lock`` is held across ``sendall`` by design)."""
        comment = ctx.comments.get(line_no)
        if comment:
            m = _BLOCKING_OK_RE.search(comment)
            if m:
                return m.group(1).strip() or "annotated"
        return None

    # lock definitions + aliases (Condition(self._x) aliases _x)
    def scan_lock_defs(cls: ast.ClassDef
                       ) -> Tuple[list, dict, dict, dict]:
        locks, aliases = [], {}
        lock_lines: Dict[str, int] = {}
        lock_escapes: Dict[str, str] = {}
        for node in ast.walk(cls):
            if not isinstance(node, ast.Assign) or \
                    not isinstance(node.value, ast.Call):
                continue
            ctor = attr_tail(node.value.func)
            if ctor not in _LOCK_CTORS:
                continue
            for t in node.targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    locks.append(t.attr)
                    lock_lines[t.attr] = node.lineno
                    why = _def_escape(node.lineno)
                    if why is not None:
                        lock_escapes[t.attr] = why
                    if ctor == "Condition" and node.value.args:
                        spec = _lockspec(node.value.args[0])
                        if spec is not None and spec[0] == "self":
                            aliases[t.attr] = spec[1]
        return locks, aliases, lock_lines, lock_escapes

    module_locks: List[str] = []
    module_lock_lines: Dict[str, int] = {}
    module_lock_escapes: Dict[str, str] = {}
    for node in ctx.tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Call):
            if attr_tail(node.value.func) in _LOCK_CTORS:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        module_locks.append(t.id)
                        module_lock_lines[t.id] = node.lineno
                        why = _def_escape(node.lineno)
                        if why is not None:
                            module_lock_escapes[t.id] = why

    # lock-order declarations: comment anywhere; owner class = the
    # class whose body encloses the comment line (None at module level)
    lock_orders: List[list] = []
    class_spans = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ClassDef):
            class_spans.append((node.lineno,
                                getattr(node, "end_lineno", node.lineno),
                                node.name))
            locks, aliases, lock_lines, lock_escapes = \
                scan_lock_defs(node)
            classes[node.name] = {"locks": locks, "aliases": aliases,
                                  "lock_lines": lock_lines,
                                  "lock_escapes": lock_escapes}

    def owner_class(line_no: int) -> Optional[str]:
        # innermost (tightest) class span containing the line
        best = None
        for start, end, name in class_spans:
            if start <= line_no <= end and (
                    best is None or (end - start) < best[0]):
                best = (end - start, name)
        return best[1] if best else None

    for line_no, comment in ctx.comments.items():
        m = _LOCK_ORDER_RE.search(comment)
        if not m:
            continue
        owner = owner_class(line_no)
        elements = [e.strip() for e in m.group(1).split("->")]
        lock_orders.append([line_no, owner, elements])

    # `# guarded-by:` annotations — bound to the field assigned on the
    # annotation's line (class scope: `self.<field>`, module scope:
    # column-0 `<name> =`). Unbound annotations are kept so the
    # sanitizer-coverage pass can flag them as orphaned.
    guarded: Dict[str, dict] = {}       # owner ('' = module) -> fields
    guarded_comments: List[list] = []   # [line, lock, field?, owner?]
    for line_no, comment in sorted(ctx.comments.items()):
        m = _GUARDED_RE.search(comment)
        if not m:
            continue
        lock = m.group(1)
        owner = owner_class(line_no)
        src = ctx.lines[line_no - 1] if line_no - 1 < len(ctx.lines) \
            else ""
        field = None
        if owner is not None:
            fm = _SELF_FIELD_RE.search(src)
            if fm:
                field = fm.group(1)
        else:
            fm = _MODULE_FIELD_RE.match(src)
            if fm:
                field = fm.group(1)
        guarded_comments.append([line_no, lock, field, owner])
        if field is not None:
            guarded.setdefault(owner or "", {})[field] = \
                {"lock": lock, "line": line_no}

    # Scope lookup via one precomputed span table (summaries must
    # carry the same "Class.method" strings ctx.scope_of_line would
    # give, so rpc-surface fingerprints survive the move to phase 2 —
    # but without an O(tree) walk per site).
    spans: List[Tuple[int, int, str]] = []

    def collect_spans(n: ast.AST, trail: List[str]) -> None:
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.ClassDef, ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                trail.append(child.name)
                spans.append((child.lineno,
                              getattr(child, "end_lineno", child.lineno),
                              ".".join(trail)))
                collect_spans(child, trail)
                trail.pop()
            else:
                collect_spans(child, trail)

    collect_spans(ctx.tree, [])

    def scope_at(line: int) -> str:
        best = None
        for start, end, dotted in spans:
            if start <= line <= end and (
                    best is None or (end - start) < best[0]):
                best = (end - start, dotted)
        return best[1] if best else "<module>"

    # `# unbounded-ok:` annotated lines — carried into the contract
    # manifest so reviewed unbounded-growth escapes stay visible to
    # the sanitizer tooling alongside the blocking escapes.
    unbounded_ok_sites: List[int] = sorted(
        line for line, c in ctx.comments.items() if "unbounded-ok:" in c)

    # chaos hook sites (`chaos.fire(component, point, ...)`) — the
    # manifest records them so a sanitized chaos run can report which
    # fault points the enforcement actually covered, and the
    # chaos-coverage pass matches them against docs/tests. Entries:
    # [line, method, component, point, detail, unreachable_ok] where
    # component/detail degrade to "*" when dynamic (rpc.py's
    # `chaos.fire(component, "send", _frame_method(obj))`) and detail
    # keeps an f-string's constant prefix (`save_*`).
    chaos_points: List[list] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not (isinstance(fn, ast.Attribute)
                and fn.attr in _CHAOS_METHODS):
            continue
        recv = attr_tail(fn.value)
        if recv is None or "chaos" not in recv.lower():
            continue
        point = _literal_str(node.args[1]) if len(node.args) > 1 \
            else None
        if point is None:
            continue
        component = (_literal_str(node.args[0]) or "*") if node.args \
            else "*"
        detail = _str_shape(node.args[2]) if len(node.args) > 2 else ""
        ok = suppressed_by_mark(ctx, node, _CHAOS_UNREACHABLE_MARK)
        chaos_points.append([node.lineno, fn.attr, component, point,
                             detail, ok])

    # metric constructor sites (`Gauge("ray_tpu_x", ..., tag_keys=...)`)
    # — the metric-discipline pass checks declaration locality, label
    # consistency, and the both-direction docs-table contract from
    # these. tag_keys: list of label names, or None when the keyword
    # is present but not a literal tuple/list of strings.
    metric_decls: List[list] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        ctor = attr_tail(node.func)
        if ctor not in _METRIC_CTORS:
            continue
        name = _literal_str(node.args[0])
        if name is None or not name.startswith("ray_tpu_"):
            continue
        tag_keys: Optional[List[str]] = []
        for kw in node.keywords:
            if kw.arg != "tag_keys":
                continue
            if isinstance(kw.value, (ast.Tuple, ast.List)):
                keys = [_literal_str(e) for e in kw.value.elts]
                tag_keys = keys if all(k is not None for k in keys) \
                    else None
            else:
                tag_keys = None
        metric_decls.append([node.lineno, ctor, name, tag_keys,
                             scope_at(node.lineno)])

    # taxonomy raise sites + broad-except handlers (error-flow pass)
    raises: List[list] = []
    excepts: List[list] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Raise) and node.exc is not None:
            exc = node.exc
            name = attr_tail(exc.func) if isinstance(exc, ast.Call) \
                else attr_tail(exc)
            if name is not None:
                raises.append([node.lineno, name,
                               scope_at(node.lineno)])
        elif isinstance(node, ast.Try):
            try_start = node.body[0].lineno
            try_end = max(getattr(stmt, "end_lineno", stmt.lineno)
                          for stmt in node.body)
            for handler in node.handlers:
                names: List[str] = []
                t = handler.type
                if t is None:
                    names = ["*"]
                elif isinstance(t, ast.Tuple):
                    names = [attr_tail(e) or "?" for e in t.elts]
                else:
                    names = [attr_tail(t) or "?"]
                broad = any(n in ("*", "Exception", "BaseException")
                            for n in names)
                reraises = any(isinstance(n, ast.Raise)
                               for stmt in handler.body
                               for n in ast.walk(stmt))
                ok = suppressed_by_mark(ctx, handler, _SWALLOW_OK_MARK)
                excepts.append([handler.lineno, try_start, try_end,
                                broad, names, reraises, ok,
                                scope_at(handler.lineno)])

    # exception-class structure (error-flow pass): bases, whether the
    # class defines __init__/__reduce__, which self fields its
    # __init__ assigns, and whether it chains to super().__init__.
    exc_classes: Dict[str, dict] = {}
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        base_names = [attr_tail(b) or "?" for b in node.bases]
        if not (_EXCISH_RE.search(node.name)
                or any(_EXCISH_RE.search(b) for b in base_names)):
            continue
        has_init = has_reduce = calls_super_init = False
        init_sets: List[str] = []
        for item in node.body:
            if not isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if item.name == "__reduce__":
                has_reduce = True
            if item.name != "__init__":
                continue
            has_init = True
            for sub in ast.walk(item):
                if isinstance(sub, ast.Assign):
                    for t in sub.targets:
                        if (isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"):
                            init_sets.append(t.attr)
                elif (isinstance(sub, ast.Call)
                      and isinstance(sub.func, ast.Attribute)
                      and sub.func.attr == "__init__"
                      and isinstance(sub.func.value, ast.Call)
                      and attr_tail(sub.func.value.func) == "super"):
                    calls_super_init = True
        exc_classes[node.name] = {
            "line": node.lineno,
            "bases": base_names,
            "has_init": has_init,
            "has_reduce": has_reduce,
            "init_sets": sorted(set(init_sets)),
            "calls_super_init": calls_super_init,
        }

    # the ingress HTTP error table literal (error-flow pass)
    http_table: Optional[dict] = None
    for node in ctx.tree.body:
        if not isinstance(node, ast.Assign) \
                or not isinstance(node.value, ast.Dict):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name) and t.id == _HTTP_TABLE_NAME:
                entries: Dict[str, int] = {}
                for k, v in zip(node.value.keys, node.value.values):
                    key = _literal_str(k) if k is not None else None
                    if key is not None and isinstance(v, ast.Constant) \
                            and isinstance(v.value, int):
                        entries[key] = v.value
                http_table = {"line": node.lineno, "map": entries}

    # RPC surface (phase-2 rpc-surface pass links these project-wide)
    rpc_regs: List[list] = []
    rpc_calls: List[list] = []
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
            target = attr_tail(node.args[1]) if len(node.args) > 1 \
                else None
            rpc_regs.append([name, node.lineno, external, target,
                             scope_at(node.lineno)])
        elif fname in _RPC_CALL_METHODS or fname.endswith("_call") \
                or fname.endswith("_oneway"):
            for arg in node.args[:2]:
                name = _literal_str(arg)
                if name is not None:
                    rpc_calls.append([name, node.lineno,
                                      scope_at(node.lineno)])
                    break

    # _FASTFRAME_SAFE literal (rpc.py today; fixtures may carry their
    # own so they stay self-contained)
    fastframe: Optional[List[str]] = None
    for node in ctx.tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "_FASTFRAME_SAFE":
                    names = [_literal_str(e)
                             for e in ast.walk(node.value)
                             if isinstance(e, ast.Constant)]
                    fastframe = sorted({n for n in names if n})

    # functions
    blocking_ok_sites: List[list] = []

    def walk_functions(body, cls: Optional[str], prefix: str) -> None:
        for node in body:
            if isinstance(node, ast.ClassDef):
                walk_functions(node.body, node.name,
                               prefix + node.name + ".")
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                qual = prefix + node.name
                held0 = [["self", h] if cls else ["name", h]
                         for h in _held_annotation(ctx, node)]
                s = _FnSummarizer(ctx, cls, held0)
                s._visit_block(node.body)
                params = [a.arg for a in node.args.posonlyargs
                          + node.args.args]
                if node.args.vararg is not None:
                    params.append("*" + node.args.vararg.arg)
                functions[qual] = {
                    "cls": cls,
                    "name": node.name,
                    "line": node.lineno,
                    "params": params,
                    "held0": [list(h) for h in held0],
                    "events": s.events,
                    "gates": s.gates,
                    "taint_flow": _collect_taint_flow(node),
                }
                blocking_ok_sites.extend(s.escapes)
                walk_functions(node.body, cls, qual + ".")

    walk_functions(ctx.tree.body, None, "")

    return {
        "path": ctx.path,
        "classes": classes,
        "module_locks": module_locks,
        "module_lock_lines": module_lock_lines,
        "module_lock_escapes": module_lock_escapes,
        "functions": functions,
        "lock_orders": lock_orders,
        "guarded": guarded,
        "guarded_comments": guarded_comments,
        "chaos_points": chaos_points,
        "blocking_ok_sites": blocking_ok_sites,
        "unbounded_ok_sites": unbounded_ok_sites,
        "rpc_regs": rpc_regs,
        "rpc_calls": rpc_calls,
        "fastframe_safe": fastframe,
        "metric_decls": metric_decls,
        "raises": raises,
        "excepts": excepts,
        "exc_classes": exc_classes,
        "http_table": http_table,
    }


# ---------------------------------------------------------------------------
# Phase 2: the project graph
# ---------------------------------------------------------------------------

# Call-resolution ambiguity cap: a bare method name matching more
# project functions than this is treated as unresolvable (edges
# through it would be guesses).
_MAX_CANDIDATES = 4

# Names that must never resolve to project functions: Python builtins
# plus the ubiquitous file/container verbs — `fh.write(...)` matching
# some class's `write` method would fabricate call edges everywhere.
_NEVER_RESOLVE = frozenset(dir(_builtins)) | frozenset((
    "write", "read", "readline", "readlines", "close", "flush",
    "seek", "append", "extend", "pop", "popleft", "add", "discard",
    "remove", "clear", "update", "get", "keys", "values", "items",
    "join", "split", "strip", "encode", "decode", "copy", "start",
))

# Closure depth bound: evidence chains longer than this are beyond
# what a reviewer can audit, and real inversions show up shallow.
_MAX_DEPTH = 6


class FuncInfo:
    __slots__ = ("path", "qual", "data")

    def __init__(self, path: str, qual: str, data: dict):
        self.path = path
        self.qual = qual
        self.data = data

    @property
    def cls(self) -> Optional[str]:
        return self.data["cls"]

    @property
    def name(self) -> str:
        return self.data["name"]

    @property
    def key(self) -> str:
        return f"{self.path}::{self.qual}"


class ProjectGraph:
    """Linked view over every file summary; shared by the phase-2
    passes (each invocation builds one graph, passes reuse its memoized
    closures)."""

    def __init__(self, summaries: Dict[str, dict],
                 root: Optional[str] = None):
        self.summaries = summaries
        # repo root for passes that must read non-Python surfaces
        # (docs tables, test literals); None when the caller runs on
        # detached fixture files.
        self.root = root
        self.by_name: Dict[str, List[FuncInfo]] = {}
        self.by_cls_name: Dict[Tuple[str, str], List[FuncInfo]] = {}
        self.by_key: Dict[str, FuncInfo] = {}
        # lock name -> defining classes; class -> {alias -> canonical}
        self.lock_defs: Dict[str, List[str]] = {}
        self.aliases: Dict[str, Dict[str, str]] = {}
        self.module_locks: Dict[str, List[str]] = {}
        self.fastframe_safe: set = set()
        for path, s in summaries.items():
            for cls, info in s.get("classes", {}).items():
                for lock in info["locks"]:
                    self.lock_defs.setdefault(lock, [])
                    if cls not in self.lock_defs[lock]:
                        self.lock_defs[lock].append(cls)
                if info["aliases"]:
                    self.aliases.setdefault(cls, {}).update(
                        info["aliases"])
            self.module_locks[path] = s.get("module_locks", [])
            if s.get("fastframe_safe"):
                self.fastframe_safe.update(s["fastframe_safe"])
            for qual, data in s.get("functions", {}).items():
                fi = FuncInfo(path, qual, data)
                self.by_key[fi.key] = fi
                self.by_name.setdefault(fi.name, []).append(fi)
                if fi.cls is not None:
                    self.by_cls_name.setdefault(
                        (fi.cls, fi.name), []).append(fi)
        self._acq_memo: Dict[str, set] = {}
        self._blk_memo: Dict[str, list] = {}

    # -- resolution ----------------------------------------------------

    def resolve_call(self, fi: FuncInfo, callee: str, recv: str
                     ) -> List[FuncInfo]:
        """Project functions a call site may land on. ``self.x()``
        prefers the enclosing class; a receiver whose snake_case name
        matches a candidate's class (``self.dependency_manager.
        cancel_task`` -> ``DependencyManager.cancel_task``) narrows to
        it; otherwise fall back to the global name table under the
        ambiguity cap. Builtin names (``zip``, ``set``, ``open``,
        file-object verbs) never resolve into the project — a call to
        ``fh.write`` landing on some class's ``write`` method is how a
        whole-program lint starts crying wolf."""
        if callee in _NEVER_RESOLVE:
            return []
        if recv == "self" and fi.cls is not None:
            own = self.by_cls_name.get((fi.cls, callee))
            if own:
                return own
        candidates = self.by_name.get(callee, [])
        if recv and len(candidates) > 1:
            recv_key = recv.lstrip("_").replace("_", "").lower()
            narrowed = [c for c in candidates if c.cls is not None
                        and c.cls.lstrip("_").lower() == recv_key]
            if narrowed:
                return narrowed
        if 0 < len(candidates) <= _MAX_CANDIDATES:
            return candidates
        return []

    def _canonical(self, cls: str, name: str) -> str:
        return self.aliases.get(cls, {}).get(name, name)

    def lock_node_known(self, node: Tuple[str, str]) -> bool:
        """True when ``(owner, name)`` maps to a lock DEFINITION the
        tree actually contains (a class attribute assignment or a
        module-level lock) — the sanitizer-coverage pass's notion of
        an instrumentable site."""
        owner, name = node
        if owner.startswith("mod:"):
            return name in self.module_locks.get(owner[4:], ())
        name = self._canonical(owner, name)
        return owner in self.lock_defs.get(name, ())

    def resolve_lock(self, fi: FuncInfo, spec: Sequence
                     ) -> List[Tuple[str, str]]:
        """lockspec -> [(owner, name)] nodes (empty = unresolvable or
        not a lock). ``owner`` is a class name or ``mod:<path>``."""
        kind = spec[0]
        if kind == "self":
            name = spec[1]
            cls = fi.cls
            if cls is not None:
                name = self._canonical(cls, name)
                if name in self.summaries.get(fi.path, {}).get(
                        "classes", {}).get(cls, {}).get("locks", ()):
                    return [(cls, name)]
            defs = self.lock_defs.get(name, [])
            if len(defs) == 1:
                return [(defs[0], name)]
            if cls is not None and _LOCKISH_RE.search(name):
                return [(cls, name)]    # inherited / defined elsewhere
            return []
        if kind == "attr":
            name = spec[2]
            defs = self.lock_defs.get(name, [])
            if 1 <= len(defs) <= 2:
                return [(c, self._canonical(c, name)) for c in defs]
            return []
        if kind == "name":
            name = spec[1]
            if name in fi.data["params"] \
                    or "*" + name in fi.data["params"]:
                return []   # parameter lock: bound at the call site
            if name in self.module_locks.get(fi.path, ()):
                return [(f"mod:{fi.path}", name)]
            return []
        return []

    def param_lock_names(self, fi: FuncInfo) -> List[str]:
        """Parameters this function acquires as locks (``with lock:``
        where ``lock`` is a parameter) — resolved per call site."""
        out = []
        for ev in fi.data["events"]:
            if ev[0] == "acq" and ev[1][0] == "name" \
                    and ev[1][1] in fi.data["params"]:
                out.append(ev[1][1])
        return out

    def bind_param_locks(self, fi: FuncInfo, callee: FuncInfo,
                         lock_args: Dict[str, Sequence]
                         ) -> List[Tuple[str, str]]:
        """Locks the callee acquires *through its parameters* given
        this call site's lock-valued arguments."""
        params = callee.data["params"]
        wanted = set(self.param_lock_names(callee))
        if not wanted:
            return []
        out: List[Tuple[str, str]] = []
        for key, spec in lock_args.items():
            if key.startswith("k:"):
                pname = key[2:]
            else:
                idx = int(key)
                pname = params[idx] if idx < len(params) else None
            if pname in wanted:
                out.extend(self.resolve_lock(fi, spec))
        return out

    # -- closures ------------------------------------------------------

    def acq_closure(self, fi: FuncInfo, depth: int = _MAX_DEPTH,
                    _stack: Optional[frozenset] = None) -> set:
        """Lock nodes this function may acquire, directly or through
        calls (param-locks resolved one level up at each call site)."""
        if fi.key in self._acq_memo:
            return self._acq_memo[fi.key]
        stack = _stack or frozenset()
        if fi.key in stack or depth <= 0:
            return set()
        stack = stack | {fi.key}
        out: set = set()
        for ev in fi.data["events"]:
            if ev[0] == "acq":
                out.update(self.resolve_lock(fi, ev[1]))
            elif ev[0] == "call":
                callee, recv, meta = ev[1], ev[2], ev[3]
                for target in self.resolve_call(fi, callee, recv):
                    out |= self.acq_closure(target, depth - 1, stack)
                    out.update(self.bind_param_locks(
                        fi, target, meta.get("lock_args", {})))
        if _stack is None:      # only memoize complete computations
            self._acq_memo[fi.key] = out
        return out

    def blocking_closure(self, fi: FuncInfo, depth: int = _MAX_DEPTH,
                         _stack: Optional[frozenset] = None) -> list:
        """[(kind, desc, path, line, chain)] blocking sites reachable
        from this function, ``# blocking-ok:`` sites excluded. The
        chain is the call path from ``fi`` to the site (for the
        finding's evidence)."""
        if fi.key in self._blk_memo:
            return self._blk_memo[fi.key]
        stack = _stack or frozenset()
        if fi.key in stack or depth <= 0:
            return []
        stack = stack | {fi.key}
        out: list = []
        for ev in fi.data["events"]:
            if ev[0] == "block":
                kind, desc, ok, line = ev[1], ev[2], ev[3], ev[4]
                if not ok:
                    out.append((kind, desc, fi.path, line, fi.qual))
            elif ev[0] == "call":
                callee, recv, meta = ev[1], ev[2], ev[3]
                if meta.get("ok"):
                    continue        # call site annotated blocking-ok
                for target in self.resolve_call(fi, callee, recv):
                    for (kind, desc, path, line, chain) in \
                            self.blocking_closure(target, depth - 1,
                                                  stack):
                        out.append((kind, desc, path, line,
                                    f"{fi.qual} -> {chain}"))
        if _stack is None:
            self._blk_memo[fi.key] = out
        return out

    # -- lock-order edges ---------------------------------------------

    def lock_edges(self) -> List[tuple]:
        """All (held_node, acquired_node, path, line, via) edges: the
        project's lock-acquisition graph. ``via`` names the call chain
        for transitive edges (empty for direct nestings)."""
        edges: List[tuple] = []
        for fi in self.by_key.values():
            for ev in fi.data["events"]:
                held_specs = ev[-1]
                held_nodes: List[Tuple[str, str]] = []
                for spec in held_specs:
                    held_nodes.extend(self.resolve_lock(fi, spec))
                if not held_nodes:
                    continue
                if ev[0] == "acq":
                    line = ev[2]
                    for node in self.resolve_lock(fi, ev[1]):
                        for held in held_nodes:
                            if held != node:
                                edges.append((held, node, fi.path,
                                              line, ""))
                elif ev[0] == "call":
                    callee, recv, meta, line = (ev[1], ev[2], ev[3],
                                                ev[4])
                    acquired: set = set()
                    via = ""
                    for target in self.resolve_call(fi, callee, recv):
                        inner = self.acq_closure(target)
                        inner |= set(self.bind_param_locks(
                            fi, target, meta.get("lock_args", {})))
                        if inner:
                            acquired |= inner
                            via = f"via {fi.qual} -> {target.qual}"
                    for node in acquired:
                        for held in held_nodes:
                            if held != node:
                                edges.append((held, node, fi.path,
                                              line, via))
        return edges

    def declarations(self) -> List[tuple]:
        """[(path, line, [nodes], [raw elements])] resolved
        ``# lock-order:`` declarations."""
        out = []
        for path, s in self.summaries.items():
            for line, owner, elements in s.get("lock_orders", []):
                nodes = []
                for el in elements:
                    if "." in el:
                        cls, name = el.rsplit(".", 1)
                        nodes.append((cls, name))
                    elif owner is not None:
                        nodes.append((owner, el))
                    else:
                        nodes.append((f"mod:{path}", el))
                out.append((path, line, nodes, elements))
        return out

    # -- taint (wire-shape) -------------------------------------------

    def fastframe_handlers(self) -> List[Tuple[FuncInfo, List[str]]]:
        """(handler function, tainted parameter names) for every
        registration of a fastframe-safe method: the transported body
        elements land in the params after the connection ctx."""
        out = []
        seen = set()
        for path, s in self.summaries.items():
            for name, _line, _ext, target, _scope in s.get("rpc_regs",
                                                           []):
                if name not in self.fastframe_safe or target is None:
                    continue
                for fi in self.by_name.get(target, []):
                    if fi.key in seen:
                        continue
                    seen.add(fi.key)
                    params = list(fi.data["params"])
                    if params and params[0] in ("self", "cls"):
                        params = params[1:]
                    params = params[1:]     # the ConnectionContext arg
                    tainted = [p.lstrip("*") for p in params]
                    if tainted:
                        out.append((fi, tainted))
        return out


def build_graph(summaries: Dict[str, dict],
                root: Optional[str] = None) -> ProjectGraph:
    return ProjectGraph(summaries, root=root)
