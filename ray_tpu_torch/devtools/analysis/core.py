"""graftcheck core: two-phase pass-runner over ``ast`` with per-file
caching and a JSON baseline-suppression file.

The runtime under ``ray_tpu_torch/_private`` is a layered concurrent system
(raylet scheduling loops, worker pools, an object store, an RPC mesh);
every class of review finding so far — unlocked mutations, state
recorded before an RPC outcome is known, client/server RPC drift,
lock-order inversions, blocking work under a lock, tuple-only gates on
fastframe-normalized values, taxonomy errors that cannot survive a
pickled reply boundary, rogue metric declarations, untested chaos
points — is statically detectable. This framework turns those one-off
catches into a permanent ratchet: sixteen passes (see ``passes/``)
run over the tree, unsuppressed findings fail the build (tier-1 runs
the suite via ``tests/test_torch_static_analysis_tree.py``).

Execution is two-phase (graftcheck v2):

- **Phase 1** (per file, cached on mtime/size/version): the per-file
  passes run, and ``callgraph.summarize_file`` distills the file into
  a whole-program summary (functions, call edges, lock acquisitions,
  blocking sites, type gates, annotations). Both land in one cache
  entry, so a warm run re-parses nothing.
- **Phase 2** (whole program, always re-run): the summaries are linked
  into a project call graph and the cross-file passes run over it.
  Because phase 2 recomputes from the freshest summaries every run,
  editing file A invalidates any cross-file finding whose evidence
  spans A and B even when B's summary is cache-hit.

Pass protocol — a pass module exposes:

- ``PASS_ID``: short kebab-case name, stable across versions.
- ``VERSION``: int; bumping it invalidates cached findings.
- ``check_file(ctx) -> list[Finding]``   (phase-1 pass, cacheable), or
- ``check_graph(graph) -> list[Finding]`` (phase-2 pass over the
  linked ``callgraph.ProjectGraph``; always re-run, never cached), or
- ``check_project(ctxs) -> list[Finding]`` (legacy cross-file pass
  over raw FileContexts; forces a parse of every scanned file).

Suppression is two-level: a fingerprint baseline (``baseline.json``
next to this module, regenerated with ``--update-baseline``) for
accepted legacy findings, and inline source conventions documented per
pass (``# guarded-by:``, ``# lock-held:``, ``# rpc: external``,
``# lock-order:``, ``# blocking-ok:``, ``# wire-shape-ok:``).
Fingerprints hash (pass, path, enclosing scope, message) — NOT line
numbers — so unrelated edits above a finding don't unsuppress it.
Baselined findings that stop firing are *pruned*: ``run_analysis``
reports and removes them when ``prune_stale`` is set (the CLI sets it
on every full-suite run), so the suppression file cannot silently rot.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from io import StringIO
from typing import Dict, List, Optional, Sequence

CACHE_BASENAME = ".rtpu_torch_analysis_cache.json"

# The port's own documentation and tests: the doc-reading passes read
# only these, never the JAX package's docs/ or its tests.
DOCS_DIR = ("ray_tpu_torch", "docs")
TEST_GLOB = "test_torch_*.py"


@dataclass
class Finding:
    pass_id: str
    path: str          # repo-relative, '/'-separated
    line: int
    context: str       # "Class.method", "function", or "<module>"
    message: str
    # Occurrence index among same-(pass, path, context, message)
    # findings, in line order — assigned per run by run_analysis.
    # Without it, one baselined finding would also suppress every
    # FUTURE identical finding in the same scope (the ratchet breaks);
    # with it, N accepted occurrences suppress exactly the first N.
    ordinal: int = 0

    def fingerprint(self) -> str:
        key = "|".join((self.pass_id, self.path, self.context,
                        self.message, str(self.ordinal)))
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.pass_id}] "
                f"{self.context}: {self.message}")

    def to_json(self) -> dict:
        return {"pass": self.pass_id, "path": self.path,
                "line": self.line, "context": self.context,
                "message": self.message, "ordinal": self.ordinal,
                "fingerprint": self.fingerprint()}

    @staticmethod
    def from_json(d: dict) -> "Finding":
        return Finding(d["pass"], d["path"], d["line"], d["context"],
                       d["message"], d.get("ordinal", 0))


_COMMENT_RE = re.compile(r"#.*$")


def suppressed_by_mark(ctx: "FileContext", node: ast.AST,
                       mark: str) -> bool:
    """Shared suppression contract (bounded-queue / durable-write):
    the ``mark`` comment suppresses when it sits on any of the node's
    own lines, or in the contiguous COMMENT-ONLY block directly above
    it. A code line with a trailing comment ends the block — walking
    through it would let one annotation suppress unrelated findings
    further down."""
    end = getattr(node, "end_lineno", node.lineno)
    for line in range(node.lineno, end + 1):
        comment = ctx.comments.get(line)
        if comment and mark in comment:
            return True
    line = node.lineno - 1
    while line > 0 and line in ctx.comments:
        if not ctx.lines[line - 1].lstrip().startswith("#"):
            break
        if mark in ctx.comments[line]:
            return True
        line -= 1
    return False


def attr_tail(node: ast.AST) -> Optional[str]:
    """Final name of a Name/dotted-Attribute expression, e.g.
    ``raylet.worker_pool._lock`` -> ``_lock``; None for anything else.
    Shared by the passes (receiver/lock/module matching)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


@dataclass
class FileContext:
    """Everything a pass needs about one source file, parsed once."""

    path: str                   # repo-relative
    abspath: str
    source: str
    tree: ast.Module
    lines: List[str] = field(default_factory=list)
    _comments: Optional[Dict[int, str]] = None

    @property
    def comments(self) -> Dict[int, str]:
        """line number -> comment text (without leading '#'), via
        tokenize so '#' inside string literals never miscounts."""
        if self._comments is None:
            out: Dict[int, str] = {}
            try:
                for tok in tokenize.generate_tokens(
                        StringIO(self.source).readline):
                    if tok.type == tokenize.COMMENT:
                        out[tok.start[0]] = tok.string.lstrip("#").strip()
            except (tokenize.TokenError, SyntaxError, ValueError):
                pass    # ast.parse accepted the file; comments are
                        # best-effort annotations on top
            self._comments = out
        return self._comments

    def scope_of(self, node: ast.AST) -> str:
        """Dotted enclosing scope of a node ("Class.method")."""
        return self.scope_of_line(getattr(node, "lineno", 0))

    def scope_of_line(self, target_line: int) -> str:
        best: List[str] = []

        def walk(n: ast.AST, trail: List[str]) -> None:
            for child in ast.iter_child_nodes(n):
                if isinstance(child, (ast.ClassDef, ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    end = getattr(child, "end_lineno", child.lineno)
                    if child.lineno <= target_line <= end:
                        trail.append(child.name)
                        if len(trail) > len(best):
                            best[:] = trail
                        walk(child, trail)
                        trail.pop()
                else:
                    walk(child, trail)

        walk(self.tree, [])
        return ".".join(best) if best else "<module>"


def parse_file(abspath: str, root: str) -> Optional[FileContext]:
    try:
        with open(abspath, encoding="utf-8", errors="replace") as f:
            source = f.read()
        tree = ast.parse(source, filename=abspath)
    except (OSError, SyntaxError):
        return None
    rel = os.path.relpath(abspath, root).replace(os.sep, "/")
    return FileContext(path=rel, abspath=abspath, source=source,
                       tree=tree, lines=source.splitlines())


def collect_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p):
            if p.endswith(".py"):
                out.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git",
                                        "analysis_fixtures")]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return sorted(set(out))


class Baseline:
    """Fingerprint suppression set, persisted as JSON. Entries keep the
    finding's last-seen text purely for human review of the file."""

    def __init__(self, path: str):
        self.path = path
        self.entries: Dict[str, dict] = {}
        if os.path.exists(path):
            try:
                with open(path, encoding="utf-8") as f:
                    data = json.load(f)
                for e in data.get("findings", []):
                    self.entries[e["fingerprint"]] = e
            except (OSError, ValueError):
                self.entries = {}

    def suppresses(self, finding: Finding) -> bool:
        return finding.fingerprint() in self.entries

    def write(self, findings: List[Finding],
              scanned_paths: Optional[set] = None) -> None:
        """Accept ``findings`` into the baseline. Entries for files
        OUTSIDE ``scanned_paths`` are preserved — updating from a
        partial scan (one file, one directory) must not silently
        delete the suppressions the scan never looked at."""
        entries = [f.to_json() for f in findings]
        if scanned_paths is not None:
            fresh = {e["fingerprint"] for e in entries}
            entries.extend(
                e for e in self.entries.values()
                if e["path"] not in scanned_paths
                and e["fingerprint"] not in fresh)
        self._dump(entries)

    def _dump(self, entries) -> None:
        data = {
            "comment": ("graftcheck baseline: accepted findings, keyed "
                        "by fingerprint. Regenerate with `python -m "
                        "ray_tpu_torch.devtools.analysis --update-baseline`."),
            "findings": sorted(entries,
                               key=lambda d: (d["path"], d["pass"],
                                              d["line"])),
        }
        with open(self.path, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=1, sort_keys=True)
            f.write("\n")

    def prune(self, current: List[Finding],
              scanned_paths: set) -> List[dict]:
        """Drop (and return) entries that no longer fire: their path
        was fully scanned this run but their fingerprint produced no
        finding. A stale suppression is debt — the accepted problem
        was fixed, and keeping the entry would silently re-admit an
        identical future regression as 'already accepted'. Only paths
        whose PER-FILE findings were in this run's report may be
        judged — link-only files surface just their phase-2 findings,
        and pruning on that partial view would delete valid
        suppressions."""
        live = {f.fingerprint() for f in current}
        stale = [e for e in self.entries.values()
                 if e["path"] in scanned_paths
                 and e["fingerprint"] not in live]
        if stale:
            for e in stale:
                del self.entries[e["fingerprint"]]
            self._dump(list(self.entries.values()))
        return stale


class FileCache:
    """Phase-1 cache: per-file findings AND the file's whole-program
    summary, keyed on (mtime, size, passes-version). Phase-2 passes
    never cache — they relink the summaries every run."""

    def __init__(self, path: str, version_tag: str):
        self.path = path
        self.version_tag = version_tag
        self.data: Dict[str, dict] = {}
        self.dirty = False
        if path and os.path.exists(path):
            try:
                with open(path, encoding="utf-8") as f:
                    raw = json.load(f)
                if raw.get("version_tag") == version_tag:
                    self.data = raw.get("files", {})
            except (OSError, ValueError):
                pass

    def _stat_key(self, abspath: str) -> Optional[List[float]]:
        try:
            st = os.stat(abspath)
        except OSError:
            return None
        return [st.st_mtime, st.st_size]

    def get(self, abspath: str) -> Optional[tuple]:
        """(findings, summary) on a fresh hit, else None."""
        entry = self.data.get(abspath)
        if entry is None or entry.get("stat") != self._stat_key(abspath):
            return None
        if "summary" not in entry:
            return None
        return ([Finding.from_json(d) for d in entry["findings"]],
                entry["summary"])

    def put(self, abspath: str, findings: List[Finding],
            summary: dict) -> None:
        stat = self._stat_key(abspath)
        if stat is None:
            return
        self.data[abspath] = {"stat": stat,
                              "findings": [f.to_json() for f in findings],
                              "summary": summary}
        self.dirty = True

    def prune_missing(self) -> List[str]:
        """Drop (and return) entries whose file no longer exists. Runs
        on EVERY analysis (a ``--changed`` scan included): a deleted
        file's cached summary would otherwise sit in the cache forever
        and — were it ever linked — fabricate call-graph edges from
        code that is gone."""
        dead = [p for p in self.data if not os.path.exists(p)]
        for p in dead:
            del self.data[p]
            self.dirty = True
        return dead

    def save(self) -> None:
        if not (self.path and self.dirty):
            return
        try:
            with open(self.path, "w", encoding="utf-8") as f:
                json.dump({"version_tag": self.version_tag,
                           "files": self.data}, f)
        except OSError:
            pass


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def run_analysis(paths: Sequence[str],
                 root: Optional[str] = None,
                 baseline_path: Optional[str] = None,
                 use_cache: bool = True,
                 update_baseline: bool = False,
                 pass_ids: Optional[Sequence[str]] = None,
                 link_paths: Optional[Sequence[str]] = None,
                 prune_stale: bool = False,
                 report: Optional[dict] = None):
    """Run the suite; returns (unsuppressed, all_findings).

    ``root`` anchors repo-relative paths (and fingerprints); default is
    the repository root inferred from this package's location.

    ``link_paths`` extends the *whole-program link set* beyond the
    scanned ``paths``: their summaries feed phase 2 (from the cache
    when fresh, re-summarized when not), but their phase-1 findings
    are not reported — this is how ``--changed`` scans an edited
    subset while the cross-file passes still see the entire program.

    ``prune_stale`` drops baseline entries that no longer fire (path
    in the SCANNED set this run, fingerprint absent); the removed
    entries land in ``report["stale_pruned"]``. Only a full-suite run
    may prune — a restricted ``--pass`` scan sees a slice of the
    findings, and link-only files surface just their phase-2
    findings, so neither may judge a suppression stale.

    ``report``, when a dict, is filled with run metadata:
    ``timings`` (pass id -> seconds, plus ``parse+summarize``) and
    ``stale_pruned``.
    """
    import time as _time

    from ray_tpu_torch.devtools.analysis import callgraph
    from ray_tpu_torch.devtools.analysis.passes import load_passes

    passes = load_passes()
    if pass_ids is not None:
        if update_baseline:
            # A restricted-pass scan sees only a slice of the findings;
            # rewriting the baseline from it would erase every other
            # pass's accepted suppressions.
            raise ValueError(
                "--update-baseline cannot be combined with --pass: "
                "run the full suite to regenerate the baseline")
        wanted = set(pass_ids)
        unknown = wanted - {p.PASS_ID for p in passes}
        if unknown:
            raise ValueError(f"unknown pass ids: {sorted(unknown)}")
        passes = [p for p in passes if p.PASS_ID in wanted]
    if root is None:
        # ray_tpu_torch/devtools/analysis/core.py -> repo root is 3 up
        # from the package dir
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))

    version_tag = ",".join(
        [f"summary={callgraph.SUMMARY_VERSION}"]
        + [f"{p.PASS_ID}={getattr(p, 'VERSION', 0)}" for p in passes])
    cache = FileCache(os.path.join(root, CACHE_BASENAME) if use_cache
                      else "", version_tag)
    cache.prune_missing()

    file_passes = [p for p in passes if hasattr(p, "check_file")]
    graph_passes = [p for p in passes if hasattr(p, "check_graph")]
    project_passes = [p for p in passes if hasattr(p, "check_project")]

    timings: Dict[str, float] = {}

    def timed(key: str, fn):
        t0 = _time.perf_counter()
        out = fn()
        timings[key] = timings.get(key, 0.0) \
            + (_time.perf_counter() - t0)
        return out

    scan_files = collect_files(paths)
    scan_set = set(scan_files)
    all_files = list(scan_files)
    if link_paths:
        all_files += [f for f in collect_files(link_paths)
                      if f not in scan_set]

    # Phase 1: per-file passes + summaries, cache-first. A cache hit
    # skips the parse entirely; legacy check_project passes (none in
    # the standard suite) force parsing of the scanned files.
    findings: List[Finding] = []
    summaries: Dict[str, dict] = {}
    ctxs: List[FileContext] = []
    scanned_rel: set = set()
    for abspath in all_files:
        in_scan = abspath in scan_set
        cached = None if project_passes and in_scan \
            else cache.get(abspath)
        if cached is not None:
            file_findings, summary = cached
        else:
            ctx = timed("parse+summarize", lambda: parse_file(abspath,
                                                              root))
            if ctx is None:
                continue
            if project_passes and in_scan:
                ctxs.append(ctx)
            file_findings = []
            for p in file_passes:
                timed(p.PASS_ID,
                      lambda p=p: file_findings.extend(p.check_file(ctx)))
            summary = timed("parse+summarize",
                            lambda: callgraph.summarize_file(ctx))
            cache.put(abspath, file_findings, summary)
        summaries[summary["path"]] = summary
        if in_scan:
            scanned_rel.add(summary["path"])
            findings.extend(file_findings)

    # Phase 2: link and run the whole-program passes.
    graph = timed("parse+summarize",
                  lambda: callgraph.build_graph(summaries, root=root))
    for p in graph_passes:
        timed(p.PASS_ID,
              lambda p=p: findings.extend(p.check_graph(graph)))
    for p in project_passes:
        timed(p.PASS_ID,
              lambda p=p: findings.extend(p.check_project(ctxs)))
    cache.save()

    findings.sort(key=lambda f: (f.path, f.line, f.pass_id))
    # Ordinals are per-run (cached findings carry stale ones): the
    # k-th identical finding in line order gets ordinal k, so removing
    # an earlier occurrence shifts survivors into the already-accepted
    # range while a NEW occurrence lands beyond it, unsuppressed.
    occurrence: Dict[tuple, int] = {}
    for f in findings:
        key = (f.pass_id, f.path, f.context, f.message)
        f.ordinal = occurrence.get(key, 0)
        occurrence[key] = f.ordinal + 1
    if report is not None:
        report["timings"] = timings
    baseline = Baseline(baseline_path or default_baseline_path())
    if update_baseline:
        baseline.write(findings, scanned_paths=scanned_rel)
        return [], findings
    if prune_stale and pass_ids is None:
        stale = baseline.prune(findings, scanned_rel)
        if report is not None:
            report["stale_pruned"] = stale
    unsuppressed = [f for f in findings if not baseline.suppresses(f)]
    return unsuppressed, findings
