"""The readings that set the upper end of each limit: the control and the
planted faults, the reference put in the program's place.

    python3 -m portbench.control --workload <cell> --seeds 11,12,13

Training cells: on each seed the fp32 reference's checked steps, then the
same steps as the program's stand-in (1) in fp8, the control, and (2) with
the loss of each step taken over half of the batch's rows, the mean over
those; each compared with the fp32 reference by ``judge.compare_train``.
A step that returns its state unchanged needs no run: its parameters do
not change, so ``update_leaf`` reads 1.

Serving cells: on each seed the requests a run of ``--seconds`` sends,
the run's check sample of them, and at every position of the sample the
gap of the token that the fp8 reference puts first (the control), and of
a token altered where it is produced: one position's served token moved
to the next id. One JSON line a seed and reading. The benchmark's own runs
never run this; ``tests/test_pb_control.py`` runs it at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from portbench import cells, feed, judge
from portbench.drivers import serve as serve_driver
from portbench.reference import models, serve_check, train_check
from portbench.reference.precision import Precision, strict_fp32


def train_readings(cell, seed: int, device) -> list:
    c, traffic = cell.config, cell.traffic
    steps = traffic["checked_steps"]
    ref = train_check.run(c, traffic, seed, device, steps)
    out = []
    for name, kw in (("fp8", {"precision": "fp8"}),
                     ("half_batch", {"half_batch": True})):
        alt = train_check.run(c, traffic, seed, device, steps, **kw)
        out.append({"reading": name, **judge.compare_train(alt, ref)})
        del alt
    return out


@torch.no_grad()
def serve_readings(cell, seed: int, device, seconds: float) -> list:
    c, traffic = cell.config, cell.traffic
    requests = feed.requests(c, traffic, seed, seconds)
    sample = serve_driver.check_sample(requests, traffic, seed)
    strict_fp32()
    from portbench import weights
    params = weights.make(c, seed, device)
    served = []
    for q in sample:            # the fp32 reference's own first tokens
        t = torch.as_tensor(q.tokens.astype(np.int64), device=device)[None]
        ids = models.decoder_logits(Precision("fp32"), params, c, t)[0]
        served.append(ids.argmax(-1).int().cpu().numpy())
    del params
    altered = [s.copy() for s in served]
    altered[0][0] = (altered[0][0] + 1) % c["vocab_size"]
    gaps = serve_check.widest_gaps(c, seed, device,
                                   [q.tokens for q in sample], served,
                                   control=True)
    wrong = serve_check.widest_gaps(c, seed, device,
                                    [q.tokens for q in sample], altered)
    return [{"reading": "fp8", "served_gap": gaps["control"],
             "positions": gaps["positions"]},
            {"reading": "altered_token", "served_gap": wrong["served"]}]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=None,
                   help="a serving run's window (default: run_seconds)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = cells.load_cell(args.workload)
    seconds = args.seconds or cells.benchmark()["run_seconds"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if cell.driver == "train":
            rows = train_readings(cell, seed, args.device)
        else:
            rows = serve_readings(cell, seed, args.device, seconds)
        for row in rows:
            print(json.dumps({"workload": args.workload, "seed": seed,
                              **row, "seconds": time.perf_counter() - t0}))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
