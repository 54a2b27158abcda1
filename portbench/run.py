"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (the runtime, the weights made from the seed on the card, the
checked first steps or the warm-up of every batch shape) is timed as
``setup_s``; then the window runs for ``--seconds``; then the program's
state is freed and the plain reference checks what the window's path
produced. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit.
The same numbers are the last lines of standard error.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from portbench.trace import Spans  # noqa: E402

# What a run may never load: JAX, and the JAX package whose port is
# measured. Compared by whole top-level module names ("ray_tpu_torch"
# begins with "ray_tpu" and is not one of them).
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")


def forbidden_modules(modules=None) -> List[str]:
    names = {m.split(".", 1)[0] for m in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


class Run:
    """What one run is given and what it measures."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda"):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.traced, self.device = trace, device
        self.window_start: Optional[float] = None
        self.end_to_end: Dict[str, float] = {}
        self.numbers: Dict[str, float] = {}
        self.record: Dict = {}
        self.faults: List[str] = []
        self.trace = None
        self.spans = Spans()
        self.marks: List[tuple] = []     # set-up's steps, for stderr
        self.attempted = self.failed = 0
        self.memory_peak_bytes = 0

    def mark(self, what: str) -> None:
        self.marks.append((what, time.perf_counter() - PROCESS_START))

    def sync(self) -> None:
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()

    def peak_memory(self) -> int:
        """The allocator's peak on the fullest card since the run began."""
        if self.device == "cpu":
            return 0
        import torch
        return max(torch.cuda.max_memory_allocated(i)
                   for i in range(self.cell.chips))

    def free_device(self) -> None:
        gc.collect()
        if self.device != "cpu":
            import torch
            torch.cuda.empty_cache()


def device_info(r: Run) -> Dict:
    import torch
    if r.device == "cpu":   # the tests' rehearsal: no device numbers
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": r.cell.chips,
            "memory_peak_bytes": int(r.memory_peak_bytes)}
    if r.traced and r.trace is not None:
        info["busy_s"] = r.trace.busy_s()
        info["window_s"] = r.trace.window_s
    return info


def result_line(r: Run, verdict: Dict, setup_s: float) -> Dict:
    from portbench import cells
    if r.traced:
        metrics = cells.per_layer_values(r.cell, r)
    else:
        values = dict(r.end_to_end, setup_s=setup_s,
                      peak_mem_gib=r.memory_peak_bytes / 2 ** 30)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in r.cell.end_to_end}
    out = {"correct": verdict["correct"], "attempted": r.attempted,
           "failed": r.failed, "metrics": metrics, "device": device_info(r)}
    if r.traced and r.trace is not None:
        out["breakdown"] = r.trace.breakdown()
    out["checks"] = verdict["checks"]
    return out


def execute(r: Run) -> Dict:
    """Run the cell's driver and judge what it produced."""
    from portbench import cells, judge
    import torch
    if r.device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    cells.driver(r.cell.driver).run(r)
    setup_s = r.window_start - PROCESS_START
    verdict = judge.verdict(r.numbers, r.cell.limits, r.faults)
    return result_line(r, verdict, setup_s), verdict


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import cells
    cell = cells.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import ray_tpu_torch  # noqa: F401  (fails here without the program)
    r = Run(cell, args.seed, args.seconds, bool(args.trace))
    r.mark("the imports are done")
    line, verdict = execute(r)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures the port "
              f"alone", file=sys.stderr)
        return 3
    for what, at in r.marks:
        print(f"set-up: {at:.3f} s {what}", file=sys.stderr)
    if r.traced and r.trace is not None:
        for name, seconds, count in r.trace.top_kernels():
            print(f"kernel {seconds:.6f} s x{count} {name}",
                  file=sys.stderr)
    print(json.dumps(line))
    sys.stdout.flush()
    from portbench import judge
    judge.print_checks(verdict)
    return 0


if __name__ == "__main__":
    sys.exit(main())
