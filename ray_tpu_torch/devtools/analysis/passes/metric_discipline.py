"""metric-discipline: every ``ray_tpu_*`` gauge is declared once,
labeled consistently, and documented in exactly one table.

The soak harness and the autoscaler read these gauges by name; a
renamed gauge or drifted label key breaks them silently — the scrape
just returns nothing.  Three contracts:

1. **declaration locality** — a metric constructor (``Gauge`` /
   ``Counter`` / ``Histogram``) with a ``ray_tpu_*`` name literal may
   only live in the stats modules (``_private/stats.py``,
   ``serve_stats.py``, ``data_stats.py``, ``wire_stats.py``).  A
   constructor elsewhere is a rogue declaration the registry cannot
   audit.
2. **label consistency** — the same metric name declared twice must
   carry identical ``tag_keys``; two shapes for one name means one
   emitter is silently dropping labels on the floor.
3. **docs both ways** — every declared metric appears in exactly one
   markdown table row across ``ray_tpu_torch/docs/``, with label keys
   matching the declaration; and every ``ray_tpu_*`` token in a docs
   table names a declared metric.  A ghost doc row documents a gauge that does not
   exist; an undocumented gauge is invisible to operators.  (The same
   discipline the lock-order table has.)

Doc checks are gated on the graph actually containing a stats module
and a repo root — a detached fixture run checks 1 and 2 only.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.devtools.analysis.core import DOCS_DIR, Finding

PASS_ID = "metric-discipline"
VERSION = 1

_STATS_BASENAMES = frozenset((
    "stats.py", "serve_stats.py", "data_stats.py", "wire_stats.py"))

# `ray_tpu_dcn_bytes` or `ray_tpu_tasks{state}` /
# `ray_tpu_tasks{state="shed"}` inside a markdown table row.
_DOC_METRIC_RE = re.compile(
    r"\bray_tpu_([a-z0-9_]+)(\{([^}]*)\})?")
_DOC_LABEL_RE = re.compile(r"([a-z0-9_]+)\s*(?:=|$|,)")


def _is_stats_module(path: str) -> bool:
    return ("_private/" in path
            and os.path.basename(path) in _STATS_BASENAMES)


def _doc_rows(root: str) -> List[Tuple[str, int, str, Optional[set]]]:
    """(doc path, line, metric name, label set or None) for every
    ``ray_tpu_*`` token found in a markdown TABLE row under the port's
    docs directory (``DOCS_DIR``).
    Prose mentions don't count — the contract is about the tables."""
    rows = []
    for doc in sorted(glob.glob(os.path.join(root, *DOCS_DIR, "*.md"))):
        rel = os.path.relpath(doc, root).replace(os.sep, "/")
        try:
            with open(doc, encoding="utf-8") as fh:
                lines = fh.read().splitlines()
        except OSError:
            continue
        for i, line in enumerate(lines, 1):
            if not line.lstrip().startswith("|"):
                continue
            for m in _DOC_METRIC_RE.finditer(line):
                labels = None
                if m.group(3) is not None:
                    labels = {lm.group(1) for lm in
                              _DOC_LABEL_RE.finditer(m.group(3))}
                rows.append((rel, i, "ray_tpu_" + m.group(1), labels))
    return rows


def check_graph(graph) -> List[Finding]:
    findings: List[Finding] = []

    declared: Dict[str, tuple] = {}   # name -> (path, line, tag_keys)
    has_stats_module = False
    for path in sorted(graph.summaries):
        s = graph.summaries[path]
        decls = s.get("metric_decls", [])
        if _is_stats_module(path):
            has_stats_module = True
        for line, ctor, name, tag_keys, scope in decls:
            if not _is_stats_module(path):
                findings.append(Finding(
                    PASS_ID, path, line, scope,
                    f"{ctor}(\"{name}\") declared outside the stats "
                    "modules — move the constructor into "
                    "_private/stats.py (or the plane's *_stats.py) "
                    "so the registry and docs contract can see it"))
                continue
            if name in declared:
                dpath, dline, dkeys = declared[name]
                if tag_keys != dkeys:
                    findings.append(Finding(
                        PASS_ID, path, line, scope,
                        f"`{name}` re-declared with tag_keys="
                        f"{tag_keys!r} but {dpath}:{dline} declares "
                        f"{dkeys!r} — one emitter is dropping labels"))
            else:
                declared[name] = (path, line, tag_keys)

    # docs contract: needs real declarations and a repo to read
    root = getattr(graph, "root", None)
    if not has_stats_module or not root or \
            not os.path.isdir(os.path.join(root, *DOCS_DIR)):
        return findings

    rows = _doc_rows(root)
    rows_by_name: Dict[str, list] = {}
    for rel, line, name, labels in rows:
        rows_by_name.setdefault(name, []).append((rel, line, labels))

    for name in sorted(rows_by_name):
        if name not in declared:
            rel, line, _ = rows_by_name[name][0]
            findings.append(Finding(
                PASS_ID, rel, line, "<doc-table>",
                f"docs table lists `{name}` but no stats module "
                "declares it — ghost gauge (stale rename?)"))

    for name in sorted(declared):
        dpath, dline, dkeys = declared[name]
        hits = rows_by_name.get(name, [])
        if not hits:
            findings.append(Finding(
                PASS_ID, dpath, dline, "<module>",
                f"`{name}` is declared but appears in no docs table "
                "— add a row to the metric registry in "
                "ray_tpu_torch/docs/"))
            continue
        if len(hits) > 1:
            rel, line, _ = hits[1]
            where = ", ".join(f"{r}:{ln}" for r, ln, _ in hits)
            findings.append(Finding(
                PASS_ID, rel, line, "<doc-table>",
                f"`{name}` appears in {len(hits)} docs table rows "
                f"({where}) — exactly one table owns each gauge, or "
                "the copies drift"))
        rel, line, labels = hits[0]
        if labels is not None and dkeys is not None and \
                not labels <= set(dkeys):
            extra = sorted(labels - set(dkeys))
            findings.append(Finding(
                PASS_ID, rel, line, "<doc-table>",
                f"docs row for `{name}` shows label(s) "
                f"{', '.join(extra)} the declaration "
                f"({dpath}:{dline}) does not carry"))
    return findings
