"""Contract-manifest emission: graftcheck phase-1 summaries -> the
machine-readable contract file graftsan enforces at runtime.

``python -m ray_tpu_torch.devtools.analysis --emit-contracts`` distills the
tree's declared concurrency contracts into
``devtools/analysis/contracts.json``:

- ``lock_sites``: ``"<relpath>:<line>" -> {name, escape?}`` — every
  lock DEFINITION site (``self._x = threading.Lock()`` / module-level
  lock assignment), named class-qualified (``Raylet._push_lock``) or
  module-qualified (``mod:<relpath>.<name>``). The sanitizer's patched
  lock factories look the creation site up here to attribute each live
  lock object to its declared identity. ``escape`` carries a
  ``# blocking-ok: <why>`` from the definition line: holding THIS lock
  across a blocking call is the reviewed design (``_send_lock`` over
  ``sendall`` is frame atomicity, not a stall bug).
- ``guarded``: ``relpath -> owner -> field -> lock`` from
  ``# guarded-by:`` annotations (owner ``""`` = module-level state,
  declarative only — descriptors can't intercept module globals).
- ``orders``: resolved ``# lock-order:`` declarations, nodes rendered
  like the lock names above so runtime acquisition pairs are directly
  comparable.
- ``blocking_escapes``: line spans of ``# blocking-ok:`` annotated
  call sites — a runtime blocking probe whose caller frame lands in a
  span does not fire.
- ``unbounded_escapes`` / ``chaos_points``: reviewed unbounded-growth
  sites and fault-injection hooks, for coverage reporting.

The manifest is committed and asserted in-sync by the test suite (same
workflow as the findings baseline): regenerate after changing any
annotation or lock definition.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

MANIFEST_VERSION = 1

MANIFEST_BASENAME = "contracts.json"


def default_manifest_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        MANIFEST_BASENAME)


def _default_root() -> str:
    # ray_tpu_torch/devtools/analysis/contracts.py -> repo root is 4 up
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))


def collect_summaries(paths: Optional[Sequence[str]] = None,
                      root: Optional[str] = None,
                      use_cache: bool = True) -> Dict[str, dict]:
    """Phase-1 summaries for ``paths`` (default: the ray_tpu_torch package),
    read through the shared analysis cache when fresh. The cache is
    never written here: a summary produced without running the
    per-file passes must not be stored as if its findings were empty.
    """
    from ray_tpu_torch.devtools.analysis import callgraph
    from ray_tpu_torch.devtools.analysis.core import (CACHE_BASENAME,
                                                FileCache,
                                                collect_files,
                                                parse_file)
    from ray_tpu_torch.devtools.analysis.passes import load_passes

    if root is None:
        root = _default_root()
    if paths is None:
        paths = [os.path.join(root, "ray_tpu_torch")]
    version_tag = ",".join(
        [f"summary={callgraph.SUMMARY_VERSION}"]
        + [f"{p.PASS_ID}={getattr(p, 'VERSION', 0)}"
           for p in load_passes()])
    cache = FileCache(os.path.join(root, CACHE_BASENAME) if use_cache
                      else "", version_tag)
    summaries: Dict[str, dict] = {}
    for abspath in collect_files(paths):
        cached = cache.get(abspath)
        if cached is not None:
            summary = cached[1]
        else:
            ctx = parse_file(abspath, root)
            if ctx is None:
                continue
            summary = callgraph.summarize_file(ctx)
        summaries[summary["path"]] = summary
    return summaries


def _node_name(owner: str, name: str) -> str:
    return f"{owner}.{name}"


def emit_contracts(paths: Optional[Sequence[str]] = None,
                   root: Optional[str] = None,
                   use_cache: bool = True) -> dict:
    """Build the manifest dict (deterministic: all maps/lists sorted,
    so the committed file diffs cleanly)."""
    from ray_tpu_torch.devtools.analysis import callgraph

    summaries = collect_summaries(paths, root, use_cache)
    graph = callgraph.build_graph(summaries)

    lock_sites: Dict[str, dict] = {}
    guarded: Dict[str, dict] = {}
    blocking_escapes = []
    unbounded_escapes = []
    chaos_points = []
    for path in sorted(summaries):
        s = summaries[path]
        for cls in sorted(s.get("classes", {})):
            info = s["classes"][cls]
            for attr in sorted(info.get("lock_lines", {})):
                line = info["lock_lines"][attr]
                entry = {"name": _node_name(cls, attr)}
                why = info.get("lock_escapes", {}).get(attr)
                if why:
                    entry["escape"] = why
                lock_sites[f"{path}:{line}"] = entry
        for name in sorted(s.get("module_lock_lines", {})):
            line = s["module_lock_lines"][name]
            entry = {"name": _node_name(f"mod:{path}", name)}
            why = s.get("module_lock_escapes", {}).get(name)
            if why:
                entry["escape"] = why
            lock_sites[f"{path}:{line}"] = entry
        for owner in sorted(s.get("guarded", {})):
            fields = s["guarded"][owner]
            out = {field: fields[field]["lock"]
                   for field in sorted(fields)}
            if out:
                guarded.setdefault(path, {})[owner] = out
        for line, end in sorted(s.get("blocking_ok_sites", [])):
            blocking_escapes.append({"path": path, "line": line,
                                     "end": end})
        for line in s.get("unbounded_ok_sites", []):
            unbounded_escapes.append({"path": path, "line": line})
        for line, method, component, point, detail, ok in sorted(
                s.get("chaos_points", [])):
            entry = {"path": path, "line": line,
                     "method": method,
                     "component": component,
                     "point": point}
            if detail:
                entry["detail"] = detail
            if ok:
                entry["unreachable"] = True
            chaos_points.append(entry)

    orders = []
    for path, line, nodes, elements in sorted(graph.declarations()):
        orders.append({"path": path, "line": line,
                       "nodes": [_node_name(o, n) for o, n in nodes],
                       "elements": list(elements)})

    return {
        "comment": ("graftsan contract manifest, emitted from "
                    "graftcheck phase-1 summaries. Regenerate with "
                    "`python -m ray_tpu_torch.devtools.analysis "
                    "--emit-contracts`."),
        "version": MANIFEST_VERSION,
        "lock_sites": lock_sites,
        "guarded": guarded,
        "orders": orders,
        "blocking_escapes": blocking_escapes,
        "unbounded_escapes": unbounded_escapes,
        "chaos_points": chaos_points,
    }


def render_manifest(manifest: dict) -> str:
    return json.dumps(manifest, indent=1, sort_keys=True) + "\n"


def write_contracts(manifest: dict,
                    out_path: Optional[str] = None) -> str:
    out_path = out_path or default_manifest_path()
    with open(out_path, "w", encoding="utf-8") as f:
        f.write(render_manifest(manifest))
    return out_path


def load_manifest(path: Optional[str] = None) -> Optional[dict]:
    """Committed manifest, or None when absent/corrupt (the sanitizer
    treats that as 'nothing to enforce' rather than failing import)."""
    path = path or os.environ.get("RTPU_SANITIZE_MANIFEST") \
        or default_manifest_path()
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None
