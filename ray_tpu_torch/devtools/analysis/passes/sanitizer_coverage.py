"""sanitizer-coverage: every declared concurrency contract must map
to a site graftsan can instrument, and no annotation may be orphaned.

The contract manifest (``--emit-contracts``) is only as good as the
annotations it compiles. Three ways an annotation rots into a no-op:

- a ``# guarded-by:`` comment that binds to no field — it sits on a
  prose line instead of the ``self.<field> = ...`` (or column-0
  module ``<name> = ...``) assignment, so neither the lock-discipline
  pass nor graftsan's descriptors enforce anything;
- a bound ``# guarded-by:`` / ``# lock-held:`` naming a lock no class
  or module in the tree defines — a typo'd lock name silently guards
  nothing;
- a ``# lock-order:`` element that resolves to no known lock
  definition — the declared order can never match a runtime
  acquisition pair, so inversions against it go unchecked.

Each is reported here so the annotation gets fixed instead of
shipping as decoration. Scope matches the other concurrency passes.
"""

from __future__ import annotations

from typing import List

from ray_tpu_torch.devtools.analysis.core import Finding

PASS_ID = "sanitizer-coverage"
VERSION = 1

_SCOPES = ("_private/", "collective/", "multislice/", "serve/",
           "analysis_fixtures/")


def _in_scope(path: str) -> bool:
    return any(s in path for s in _SCOPES)


def check_graph(graph) -> List[Finding]:
    findings: List[Finding] = []
    for path in sorted(graph.summaries):
        if not _in_scope(path):
            continue
        s = graph.summaries[path]
        module_locks = set(s.get("module_locks", ()))

        def lock_known(lock: str, owner) -> bool:
            # class scope: defined by the owner class (through a
            # Condition alias too), by the file's module, or — for
            # locks inherited / defined on another class — by any
            # class in the tree. Module scope: this module only.
            if owner is not None:
                canonical = graph._canonical(owner, lock)
                return (owner in graph.lock_defs.get(canonical, ())
                        or lock in module_locks
                        or canonical in graph.lock_defs)
            return lock in module_locks

        for line, lock, field, owner in s.get("guarded_comments", []):
            where = f"class {owner}" if owner else "module level"
            if field is None:
                findings.append(Finding(
                    PASS_ID, path, line, owner or "<module>",
                    f"orphaned `# guarded-by: {lock}` ({where}): the "
                    "annotation binds to no field — put it on the "
                    "`self.<field> = ...` (or module `<name> = ...`) "
                    "assignment line it guards"))
            elif not lock_known(lock, owner):
                findings.append(Finding(
                    PASS_ID, path, line, owner or "<module>",
                    f"`# guarded-by: {lock}` on `{field}` names a "
                    f"lock with no definition in sight ({where}) — "
                    "fix the lock name or define the lock"))

    for path, line, nodes, elements in graph.declarations():
        if not _in_scope(path):
            continue
        for node, element in zip(nodes, elements):
            if not graph.lock_node_known(node):
                findings.append(Finding(
                    PASS_ID, path, line, "<module>",
                    f"`# lock-order:` element `{element}` resolves to "
                    f"no known lock definition ({node[0]}.{node[1]}) "
                    "— the declared order can never be checked; fix "
                    "the name or class-qualify it"))

    for fi in graph.by_key.values():
        if not _in_scope(fi.path):
            continue
        for spec in fi.data.get("held0", ()):
            if not graph.resolve_lock(fi, spec):
                findings.append(Finding(
                    PASS_ID, fi.path, fi.data["line"], fi.qual,
                    f"`# lock-held: {spec[-1]}` names a lock that "
                    "resolves to no known definition — the "
                    "annotation suppresses nothing"))
    return findings
