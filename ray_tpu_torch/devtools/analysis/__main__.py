"""CLI: ``python -m ray_tpu_torch.devtools.analysis [paths...]``.

Exit status: 0 when every finding is baseline-suppressed, 1 when
unsuppressed findings remain, 2 on usage errors. ``--update-baseline``
rewrites the suppression file with the current finding set (do this
only for findings reviewed and accepted as status quo; new code should
fix, not suppress).

``--changed`` scans only the files git reports as modified (staged,
unstaged, or untracked) — but the whole-program passes still link the
full summary cache, so a cross-file finding caused by your edit is
caught even when its anchor file is untouched. ``--timings`` prints
per-pass wall clock. Full-suite runs prune stale baseline entries
(reported, then removed) so the suppression file cannot silently rot.

``--ci`` is the one-flag CI entry point: the enforced full-tree
invocation plus ``--timings``, nonzero exit on any unsuppressed
finding. With a warm cache it stays well under the tier-1 bound
(``test_ci_mode_aggregates``).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from ray_tpu_torch.devtools.analysis.core import (
    default_baseline_path,
    run_analysis,
)
from ray_tpu_torch.devtools.analysis.passes import load_passes


def _default_tree() -> str:
    import ray_tpu_torch
    return os.path.dirname(os.path.abspath(ray_tpu_torch.__file__))


def _covers_default_tree(paths) -> bool:
    """True when the scanned roots contain the whole ray_tpu_torch package —
    the only scan shape allowed to judge baseline staleness. A subset
    scan (one file, one subdirectory) loses the cross-file evidence
    behind some suppressions (e.g. rpc-surface goes silent with no
    registrations in sight) and would prune valid entries."""
    tree = _default_tree()
    for p in paths:
        ap = os.path.abspath(p)
        if ap == tree or tree.startswith(ap + os.sep):
            return True
    return False


def _git_changed_files(root: str) -> tuple:
    """(existing, deleted) Python files git sees as different from
    HEAD (staged, unstaged, untracked), absolute paths.
    ``--untracked-files=all`` expands untracked DIRECTORIES to their
    files (plain status collapses a new subpackage to one ``pkg/``
    entry, which would hide every .py inside it). Raises on a non-git
    tree."""
    # --no-renames: a rename's old path arrives as a bare NUL field
    # with no "XY " status prefix, which entry[3:] would mangle;
    # disabling rename detection reports it as a plain delete + add
    proc = subprocess.run(
        ["git", "-C", root, "status", "--porcelain", "-z",
         "--untracked-files=all", "--no-renames"],
        capture_output=True, text=True, timeout=30, check=True)
    existing, deleted = [], []
    for entry in proc.stdout.split("\0"):
        if len(entry) < 4:
            continue
        path = entry[3:]
        # a rename's OLD name arrives as its own NUL field with no
        # status prefix; it fails the .py/exists guards or simply
        # re-adds an existing file, so no special-casing is needed
        if not path.endswith(".py"):
            continue
        abspath = os.path.join(root, path)
        if os.path.exists(abspath):
            existing.append(abspath)
        else:
            deleted.append(abspath)
    return sorted(set(existing)), sorted(set(deleted))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.devtools.analysis",
        description="graftcheck: concurrency & RPC-surface lint")
    parser.add_argument("paths", nargs="*",
                        help="files/directories to scan (default: the "
                             "ray_tpu_torch package)")
    parser.add_argument("--baseline", default=None,
                        help="baseline JSON path (default: "
                             f"{default_baseline_path()})")
    parser.add_argument("--update-baseline", action="store_true",
                        help="accept the current findings into the "
                             "baseline instead of failing on them")
    parser.add_argument("--no-cache", action="store_true",
                        help="ignore and don't write the per-file "
                             "findings cache")
    parser.add_argument("--pass", dest="pass_ids", action="append",
                        metavar="PASS_ID",
                        help="run only this pass (repeatable)")
    parser.add_argument("--list-passes", action="store_true",
                        help="list pass ids and exit")
    parser.add_argument("--all", action="store_true",
                        help="print suppressed findings too")
    parser.add_argument("--changed", action="store_true",
                        help="scan only git-modified files; the "
                             "whole-program passes still link the "
                             "full summary cache")
    parser.add_argument("--timings", action="store_true",
                        help="print per-pass wall-clock timings")
    parser.add_argument("--emit-contracts", action="store_true",
                        help="write the graftsan contract manifest "
                             "(devtools/analysis/contracts.json) from "
                             "the phase-1 summaries and exit")
    parser.add_argument("--ci", action="store_true",
                        help="CI aggregate mode: scan the full "
                             "ray_tpu_torch tree, print per-pass timings, "
                             "exit nonzero on any unsuppressed "
                             "finding")
    args = parser.parse_args(argv)

    if args.ci:
        # one-flag CI entry point: the enforced full-tree invocation
        # with timings, no paths to get wrong
        if args.paths or args.changed or args.pass_ids \
                or args.update_baseline:
            print("error: --ci is the full-tree aggregate mode; it "
                  "takes no paths and combines with no scan-shaping "
                  "flags", file=sys.stderr)
            return 2
        args.timings = True

    if args.emit_contracts:
        from ray_tpu_torch.devtools.analysis import contracts
        manifest = contracts.emit_contracts(args.paths or None)
        out = contracts.write_contracts(manifest)
        print(f"contracts written: {len(manifest['lock_sites'])} lock "
              f"site(s), {len(manifest['orders'])} order "
              f"declaration(s), "
              f"{sum(len(c) for g in manifest['guarded'].values() for c in g.values())} "
              f"guarded field(s) -> {out}")
        return 0

    if args.list_passes:
        for p in load_passes():
            doc = (p.__doc__ or "").strip().splitlines()[0]
            print(f"{p.PASS_ID:20s} {doc}")
        return 0

    paths = args.paths
    link_paths = None
    if args.changed:
        if paths:
            print("error: --changed picks its own file set; drop the "
                  "positional paths", file=sys.stderr)
            return 2
        # repo root: one up from the ray_tpu_torch package (matches core's
        # default fingerprint root)
        repo_root = os.path.dirname(_default_tree())
        try:
            changed, deleted = _git_changed_files(repo_root)
        except (OSError, subprocess.SubprocessError) as e:
            print(f"error: --changed needs a git checkout: {e}",
                  file=sys.stderr)
            return 2
        # only files the enforced invocation would scan: a --changed
        # run must be a subset of `analysis ray_tpu_torch/`, not a backdoor
        # that lints tests/benches with runtime-core passes
        tree_prefix = _default_tree() + os.sep
        paths = [p for p in changed if p.startswith(tree_prefix)]
        deleted = [p for p in deleted if p.startswith(tree_prefix)]
        link_paths = [_default_tree()]
        if not paths and not deleted:
            print("graftcheck: no changed .py files under ray_tpu_torch/")
            return 0
        # A deletion-only change still runs phase 2 over the linked
        # tree (paths may be empty): removing a file can orphan RPC
        # callers or lock-order evidence anchored elsewhere.
    elif not paths:
        paths = [_default_tree()]

    # Stale pruning is for full-suite runs only: a --pass slice, a
    # --changed scan, or a positional-subset scan sees part of the
    # picture and must not judge staleness.
    full_suite = (not (args.pass_ids or args.update_baseline
                       or args.changed)
                  and _covers_default_tree(paths))

    report: dict = {}
    try:
        unsuppressed, all_findings = run_analysis(
            paths,
            baseline_path=args.baseline,
            use_cache=not args.no_cache,
            update_baseline=args.update_baseline,
            pass_ids=args.pass_ids,
            link_paths=link_paths,
            prune_stale=full_suite,
            report=report)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.timings:
        for key, secs in sorted(report.get("timings", {}).items(),
                                key=lambda kv: -kv[1]):
            print(f"timing {key:22s} {secs * 1000:8.1f} ms")

    if args.update_baseline:
        print(f"baseline updated: {len(all_findings)} finding(s) "
              f"accepted into "
              f"{args.baseline or default_baseline_path()}")
        return 0

    for e in report.get("stale_pruned", []):
        print(f"stale baseline entry pruned (no longer fires): "
              f"{e['path']}: [{e['pass']}] {e['context']}: "
              f"{e['message']}")

    shown = all_findings if args.all else unsuppressed
    for f in shown:
        print(f.render())
    n_suppressed = len(all_findings) - len(unsuppressed)
    print(f"graftcheck: {len(unsuppressed)} finding(s), "
          f"{n_suppressed} baseline-suppressed")
    return 1 if unsuppressed else 0


if __name__ == "__main__":
    sys.exit(main())
