"""error-flow: the fault taxonomy must survive its trip across RPC
and HTTP reply boundaries.

Typed errors are only useful if the type arrives intact.  A taxonomy
class raised deep in ``_private/`` crosses two boundaries on its way
to a caller: ``rpc.py`` pickles it into an error frame (so it must be
pickle-safe — a custom ``__init__`` without a matching ``__reduce__``
raises ``TypeError`` *inside the reply path*, masking the original
fault), and ``ingress.py`` maps it to an HTTP status (so the status
table must cover every class that can reach it, and list nothing
that cannot).  Four contracts, all derived from phase-1 summaries:

1. **pickle-safety** — for every taxonomy class raised in scope, the
   nearest class in its base chain that defines ``__init__`` must
   also define ``__reduce__`` in the same body.  (A class with no
   custom ``__init__`` inherits its ancestor's reduce behaviour and
   is safe by construction.)
2. **overload shape** — ``SystemOverloadError`` subclasses that
   define ``__init__`` must either chain to ``super().__init__``
   (which sets the retry contract) or assign both ``retryable`` and
   ``backoff_s`` themselves; a subclass that does neither ships a
   503 with no Retry-After semantics.
3. **HTTP table closure** — the ingress ``_HTTP_STATUS_BY_TAXONOMY``
   table must resolve every shippable taxonomy class (via its base
   chain) to a status, and every key in it must name a real taxonomy
   class (a typo'd key is a dead row that LOOKS like coverage).
4. **no silent swallow** — a broad ``except`` in ``_private/`` whose
   try-body can raise a taxonomy error must re-raise something or
   carry ``# swallow-ok: <why>``; otherwise the typed signal dies in
   a handler nobody audited.

"Shippable" = raised anywhere in the scoped trees.  Every scoped
plane replies through ``rpc.py`` task/actor frames or the serve
ingress, so reachability of a raise site IS boundary reachability —
a whole-graph trace would only re-derive that at 100x the cost.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from ray_tpu_torch.devtools.analysis.core import Finding

PASS_ID = "error-flow"
VERSION = 1

_SCOPES = ("_private/", "collective/", "multislice/", "serve/",
           "data/", "analysis_fixtures/")

# Only broad handlers in these trees are audited for swallowing:
# `_private/` is the control plane every typed signal transits.
_SWALLOW_SCOPES = ("_private/", "analysis_fixtures/")

_ROOT_CLASS = "RayTpuError"
_OVERLOAD_CLASS = "SystemOverloadError"
_OVERLOAD_FIELDS = {"retryable", "backoff_s"}

# Python builtins that terminate a base-chain walk.
_BUILTIN_BASES = frozenset((
    "Exception", "BaseException", "RuntimeError", "ValueError",
    "TypeError", "OSError", "ConnectionError", "KeyError",
    "TimeoutError", "object", "?",
))


def _in_scope(path: str) -> bool:
    return any(s in path for s in _SCOPES)


class _Taxonomy:
    """Linked view of every exception class in the tree, rooted at
    ``RayTpuError``."""

    def __init__(self, graph):
        self.defs: Dict[str, dict] = {}       # name -> class info
        self.def_path: Dict[str, str] = {}    # name -> defining file
        for path, s in graph.summaries.items():
            for name, info in s.get("exc_classes", {}).items():
                # first definition wins; taxonomy names are unique in
                # practice and fixtures are self-contained
                if name not in self.defs:
                    self.defs[name] = info
                    self.def_path[name] = path
        self.members: Set[str] = set()
        for name in self.defs:
            if self._derives_from_root(name, set()):
                self.members.add(name)

    def _derives_from_root(self, name: str, seen: Set[str]) -> bool:
        if name == _ROOT_CLASS:
            return True
        if name in seen or name not in self.defs:
            return False
        seen.add(name)
        return any(self._derives_from_root(b, seen)
                   for b in self.defs[name]["bases"])

    def base_chain(self, name: str) -> List[str]:
        """Linearized ancestor walk (first base first), cycle-safe."""
        out, queue, seen = [], [name], set()
        while queue:
            n = queue.pop(0)
            if n in seen or n not in self.defs:
                continue
            seen.add(n)
            out.append(n)
            queue.extend(self.defs[n]["bases"])
        return out

    def init_definer(self, name: str) -> Optional[str]:
        """Nearest class in the chain with a custom ``__init__`` —
        the one whose constructor signature pickle must replay."""
        for n in self.base_chain(name):
            if self.defs[n]["has_init"]:
                return n
        return None

    def is_subclass(self, name: str, ancestor: str) -> bool:
        return ancestor in self.base_chain(name)


def check_graph(graph) -> List[Finding]:
    findings: List[Finding] = []
    tax = _Taxonomy(graph)
    if not tax.members:
        return findings

    # -- shippable set: taxonomy classes raised in scope --------------
    raised: Dict[str, tuple] = {}   # class -> first (path, line, scope)
    for path in sorted(graph.summaries):
        if not _in_scope(path):
            continue
        for line, exc_name, scope in \
                graph.summaries[path].get("raises", []):
            name = exc_name.rsplit(".", 1)[-1]
            if name in tax.members and name not in raised:
                raised[name] = (path, line, scope)

    # -- 1. pickle-safety ---------------------------------------------
    for name in sorted(raised):
        definer = tax.init_definer(name)
        if definer is None:
            continue    # pure inheritance all the way down: safe
        if not tax.defs[definer]["has_reduce"]:
            path, line, scope = raised[name]
            where = "" if definer == name else \
                f" (inherited from `{definer}`)"
            findings.append(Finding(
                PASS_ID, tax.def_path[definer],
                tax.defs[definer]["line"], definer,
                f"taxonomy class `{name}` crosses reply boundaries "
                f"but its constructor{where} defines __init__ with "
                "no matching __reduce__ — unpickling the error frame "
                f"will raise TypeError and mask the real fault "
                f"(first raised at {path}:{line})"))

    # -- 2. overload retry shape --------------------------------------
    for name in sorted(tax.members):
        if name == _OVERLOAD_CLASS or \
                not tax.is_subclass(name, _OVERLOAD_CLASS):
            continue
        info = tax.defs[name]
        if not info["has_init"]:
            continue    # inherits the parent contract untouched
        sets = set(info["init_sets"])
        if info["calls_super_init"] or _OVERLOAD_FIELDS <= sets:
            continue
        missing = sorted(_OVERLOAD_FIELDS - sets)
        findings.append(Finding(
            PASS_ID, tax.def_path[name], info["line"], name,
            f"`{name}` subclasses {_OVERLOAD_CLASS} but its __init__ "
            f"neither chains super().__init__ nor assigns "
            f"{', '.join(missing)} — clients get a 503 with no retry "
            "contract"))

    # -- 3. HTTP table closure ----------------------------------------
    tables = [(path, s["http_table"])
              for path, s in sorted(graph.summaries.items())
              if s.get("http_table")]
    for path, table in tables:
        mapped = set(table["map"])
        for key in sorted(mapped):
            if key not in tax.members:
                findings.append(Finding(
                    PASS_ID, path, table["line"], "<module>",
                    f"HTTP status table maps `{key}` which is not a "
                    "taxonomy class — dead row (typo or stale rename) "
                    "masquerading as coverage"))
        for name in sorted(raised):
            if not any(n in mapped for n in tax.base_chain(name)):
                rpath, rline, _ = raised[name]
                findings.append(Finding(
                    PASS_ID, path, table["line"], "<module>",
                    f"shippable taxonomy class `{name}` (raised at "
                    f"{rpath}:{rline}) resolves to no HTTP status "
                    "table entry — it would fall through the ingress "
                    "error mapping"))

    # -- 4. broad-except swallow --------------------------------------
    for path in sorted(graph.summaries):
        if not any(s in path for s in _SWALLOW_SCOPES):
            continue
        s = graph.summaries[path]
        # a taxonomy raise (or a call into a function that raises one)
        # inside the try span makes the handler's silence dangerous
        raise_lines = [line for line, exc_name, _ in s.get("raises", [])
                       if exc_name.rsplit(".", 1)[-1] in tax.members]
        call_sites = _taxonomy_call_sites(graph, s, tax)
        for (handler_line, try_start, try_end, broad, _names,
             reraises, ok, scope) in s.get("excepts", []):
            if not broad or reraises or ok:
                continue
            direct = any(try_start <= ln <= try_end
                         for ln in raise_lines)
            via = next((c for ln, c in call_sites
                        if try_start <= ln <= try_end), None)
            if not direct and via is None:
                continue
            how = "raises a taxonomy error directly" if direct else \
                f"calls `{via}` which can raise a taxonomy error"
            findings.append(Finding(
                PASS_ID, path, handler_line, scope,
                f"broad `except` swallows the fault taxonomy: the "
                f"try body {how} and the handler neither re-raises "
                "nor carries `# swallow-ok: <why>`"))
    return findings


def _taxonomy_call_sites(graph, summary, tax) -> List[tuple]:
    """(line, callee-name) for calls in this file that resolve to a
    project function whose body raises a taxonomy class (one level:
    boundary handlers wrap direct raisers; deeper chains re-raise at
    each hop or get caught closer to the fault)."""
    out = []
    for qual, data in summary.get("functions", {}).items():
        fi = graph.by_key.get(f"{summary['path']}::{qual}")
        if fi is None:
            continue
        for ev in data.get("events", []):
            if ev[0] != "call":
                continue
            callee, recv, line = ev[1], ev[2], ev[-2]
            for target in graph.resolve_call(fi, callee, recv):
                hit = any(
                    exc.rsplit(".", 1)[-1] in tax.members
                    and rscope == target.qual
                    for _rl, exc, rscope in
                    graph.summaries[target.path].get("raises", []))
                if hit:
                    out.append((line, target.qual))
                    break
    return out
