"""CLI: ``python -m ray_tpu_torch.soak --seed S --duration D``.

Runs the full composed soak (``ray_tpu_torch/docs/soak.md``) and exits 0
iff every non-skipped invariant held. ``--dry-run`` prints the deterministic
schedule and its digest without touching a cluster or a card — the
replay contract's reference side. ``--device`` (default ``cuda``) picks the
head's runtime; ``cpu`` runs the soak without a card.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.soak",
        description="composed chaos soak with an invariant oracle")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--duration", type=float, default=14.0,
                   help="chaos-window length in seconds")
    p.add_argument("--out", default="soak_out",
                   help="artifact directory (fault log, verdict)")
    p.add_argument("--report", action="store_true",
                   help="print the verdict as JSON on stdout")
    p.add_argument("--dry-run", action="store_true",
                   help="print the schedule + digest; no cluster")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the head's runtime: the card (default) or the CPU")
    args = p.parse_args(argv)

    from ray_tpu_torch.soak.schedule import generate_schedule
    if args.dry_run:
        sched = generate_schedule(args.seed, args.duration)
        for rec in sched.timeline_records():
            print(json.dumps(rec, sort_keys=True))
        print(f"digest: {sched.digest()}", file=sys.stderr)
        return 0

    from ray_tpu_torch.soak.runner import SoakConfig, SoakRunner
    verdict = SoakRunner(SoakConfig(
        seed=args.seed, duration=args.duration,
        out_dir=args.out, device=args.device)).run()
    print(verdict.render(), file=sys.stderr)
    if args.report:
        print(verdict.to_json())
    return 0 if verdict.ok else 1


if __name__ == "__main__":
    sys.exit(main())
