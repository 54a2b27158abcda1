"""chaos-coverage: every chaos injection point is documented in a
chaos-matrix row and exercised by at least one test.

A ``chaos.fire(component, point, method)`` site that no test ever
arms is a fault mode nobody has ever seen — the soak harness will
flip rules across the whole matrix, and a point
that was never exercised under test is exactly where it will find a
hang instead of a handled fault.  Two directions per point:

- **docs**: the point's dotted key must appear in some
  ``ray_tpu_torch/docs/*.md`` line (the per-plane chaos matrices);
- **tests**: the key must appear as a literal in some
  ``tests/test_torch_*.py`` — a rule string, an ``Expect`` pattern, or
  an events assertion all count, because each one arms or observes the
  point. Only the port's docs and tests count: a point that only the
  JAX package's tests arm is not exercised in the port.
  The soak plane's weight table (``ray_tpu_torch/soak/schedule.py``,
  read when it exists) counts too: every ``ArmSpec`` names its registry
  key as a literal, and any
  seed can draw and arm it, so a schedule entry IS an exerciser —
  one the long soak actually fires, not just a string in a test.

A point that genuinely cannot be exercised (e.g. would wedge the
respawn loop) carries ``# chaos-unreachable: <why>`` at the fire
site and is skipped — the why ships in the contract manifest.

Matching degrades with staticness, mirroring the summary's shape
rendering: a fully literal site needs its exact ``component.point.
method`` key present; an f-string method (``f"save_{tag}"``) needs
the ``component.point.save_`` prefix; a dynamic component (rpc.py's
``chaos.fire(component, "send", ...)``) needs any ``.send.`` rule.
Findings are deduplicated by needle so one dynamic site reports once.

Like metric-discipline's doc contract, the docs/tests scans are gated
on a repo root — detached fixture runs check nothing here unless the
fixture tree carries its own docs/tests.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Tuple

from ray_tpu_torch.devtools.analysis.core import (DOCS_DIR, TEST_GLOB,
                                                   Finding)

PASS_ID = "chaos-coverage"
VERSION = 3   # v3: cluster autoscaler (ray_tpu_torch/autoscaler/)

_SCOPES = ("_private/", "collective/", "multislice/", "serve/",
           "data/", "autoscaler/", "analysis_fixtures/")


def _in_scope(path: str) -> bool:
    return any(s in path for s in _SCOPES)


def _needle(component: str, point: str, detail: str) -> str:
    """Substring whose presence in a doc/test line proves the rule
    set can address this fire site."""
    if component == "*":
        return f".{point}."
    if detail == "":
        return f"{component}.{point}"
    if detail == "*":
        return f"{component}.{point}."
    if detail.endswith("*"):
        return f"{component}.{point}.{detail[:-1]}"
    return f"{component}.{point}.{detail}"


def _read_lines(path: str) -> List[str]:
    try:
        with open(path, encoding="utf-8") as fh:
            return fh.read().splitlines()
    except OSError:
        return []


def _scan(root: str) -> Tuple[List[str], List[str]]:
    """(docs lines, tests lines) for needle matching."""
    docs: List[str] = []
    for doc in sorted(glob.glob(os.path.join(root, *DOCS_DIR, "*.md"))):
        docs.extend(_read_lines(doc))
    tests: List[str] = []
    # the port's own test files only (fixture files under
    # tests/analysis_fixtures/ are analysis INPUTS, not exercisers)
    for fn in sorted(glob.glob(os.path.join(root, "tests", TEST_GLOB))):
        tests.extend(_read_lines(fn))
    # the soak schedule's weight table is an exerciser too: each
    # ArmSpec carries its registry key as a literal and any seed can
    # draw + arm it, so schedule entries count as test coverage (a
    # missing file reads as no lines)
    tests.extend(_read_lines(
        os.path.join(root, "ray_tpu_torch", "soak", "schedule.py")))
    return docs, tests


def check_graph(graph) -> List[Finding]:
    findings: List[Finding] = []
    root = getattr(graph, "root", None)
    if not root or not os.path.isdir(os.path.join(root, "tests")):
        return findings

    # needle -> first fire site (dedupe: one finding per direction
    # per needle, anchored at the first site in path/line order)
    sites: Dict[str, tuple] = {}
    for path in sorted(graph.summaries):
        if not _in_scope(path):
            continue
        for (line, method, component, point, detail, ok) in \
                graph.summaries[path].get("chaos_points", []):
            if ok:
                continue
            needle = _needle(component, point, detail)
            key = f"{component}.{point}" + \
                (f".{detail}" if detail else "")
            if needle not in sites:
                sites[needle] = (path, line, key)

    if not sites:
        return findings
    docs, tests = _scan(root)

    for needle in sorted(sites):
        path, line, key = sites[needle]
        if not any(needle in ln for ln in docs):
            findings.append(Finding(
                PASS_ID, path, line, "<chaos-point>",
                f"chaos point `{key}` appears in no docs chaos-matrix "
                "row — add it to the plane's matrix or annotate the "
                "site `# chaos-unreachable: <why>`"))
        if not any(needle in ln for ln in tests):
            findings.append(Finding(
                PASS_ID, path, line, "<chaos-point>",
                f"chaos point `{key}` is exercised by no test literal "
                "— a fault mode nobody has ever injected; write a "
                "chaos test or annotate `# chaos-unreachable: <why>`"))
    return findings
