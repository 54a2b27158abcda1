"""CLI: diff runtime-observed lock orders against declared contracts.

    RTPU_SANITIZE=1 RTPU_SANITIZE_OBSERVED=/tmp/obs.jsonl pytest ...
    python -m ray_tpu_torch.devtools.sanitizer --diff /tmp/obs.jsonl

Reports acquisition pairs the sanitizer actually saw that no
``# lock-order:`` declaration covers — candidates to PROMOTE into a
declaration (with the static pass then holding the line), not to
suppress.
"""

from __future__ import annotations

import argparse
import sys

from ray_tpu_torch.devtools.analysis import contracts
from ray_tpu_torch.devtools.sanitizer import report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ray_tpu_torch.devtools.sanitizer")
    ap.add_argument("--diff", metavar="OBSERVED_JSONL",
                    help="observed-pairs artifact (RTPU_SANITIZE_OBSERVED)")
    ap.add_argument("--manifest", default=None,
                    help="contract manifest (default: committed contracts.json)")
    args = ap.parse_args(argv)
    if not args.diff:
        ap.print_help()
        return 2
    manifest = contracts.load_manifest(args.manifest)
    if manifest is None:
        print("graftsan: no contract manifest; run "
              "`python -m ray_tpu_torch.devtools.analysis --emit-contracts`",
              file=sys.stderr)
        return 2
    undeclared = report.diff_observed(args.diff, manifest)
    if not undeclared:
        print("graftsan: every observed lock pair is covered by a "
              "declared `# lock-order:`")
        return 0
    print(f"graftsan: {len(undeclared)} observed pair(s) not covered "
          "by any `# lock-order:` declaration — promote, don't "
          "suppress:")
    for rec in undeclared:
        print(f"  {rec['held']} -> {rec['acquired']}   "
              f"(held at {rec.get('held_site', '?')}, acquired at "
              f"{rec.get('acq_site', '?')})")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
