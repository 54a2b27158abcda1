"""Find the highest rate a serving cell's deployment sustains: one
deployment, then an open loop of the cell's mix at each rate in turn.

    python3 -m portbench.sweep --workload <cell> --rates 8,12,16 \
        --seconds 20 --seed 7

For each rate it prints the median and 95th percentile latency, the
median latency of the first and of the last quarter of the requests by
due time (a backlog that grows shows as a last quarter far above the
first), the mean rows a forward and how far the sender fell behind. The
cell's ``rate_per_s`` is about four fifths of the highest rate whose last
quarter stays near its first. Run once when the cell is defined; the
benchmark's runs never search for a rate.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

from portbench import cells, feed, program
from portbench.drivers import serve as sd
from portbench.run import Run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    cell = cells.load_cell(args.workload)
    r = Run(cell, args.seed, args.seconds, False)
    program.start_runtime(r.device)
    try:
        handle = sd.deploy(r)
        for i, rate in enumerate(float(x) for x in args.rates.split(",")):
            reqs = feed.requests(cell.config, cell.traffic, args.seed + i,
                                 args.seconds, rate=rate)
            before = len(rt.get(handle.record.remote(), timeout=60))
            loop = sd.OpenLoop(reqs, r.spans)
            loop.run(handle.score, args.seconds)
            lat = loop.latencies()
            batches = rt.get(handle.record.remote(), timeout=60)[before:]
            order = sorted(range(len(reqs)), key=lambda j: reqs[j].due_s)
            q = max(1, len(order) // 4)
            print(json.dumps({
                "rate": rate, "requests": len(reqs),
                "p50_ms": 1e3 * sd.percentile(lat, 0.5),
                "p95_ms": 1e3 * sd.percentile(lat, 0.95),
                "first_quarter_p50_ms": 1e3 * statistics.median(
                    lat[j] for j in order[:q]),
                "last_quarter_p50_ms": 1e3 * statistics.median(
                    lat[j] for j in order[-q:]),
                "rows_a_forward": sum(b[0] for b in batches) / max(
                    1, len(batches)),
                "forward_ms_mean": 1e3 * sum(b[3] for b in batches) / max(
                    1, len(batches)),
                "padded_tokens_a_forward": sum(b[0] * b[1] for b in batches)
                / max(1, len(batches)),
                "late_s": loop.late_s}))
            sys.stdout.flush()
        serve.shutdown()
    finally:
        program.stop_runtime()
    return 0


if __name__ == "__main__":
    sys.exit(main())
