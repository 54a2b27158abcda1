#!/usr/bin/env python3
"""Time the scheduler kernels' design choices on one card: the cluster
size, the bisection levels a cluster sum and the S3 design of
``csrc/scheduler.cu``.

Usage, from the root of a checkout:

    python3 ray_tpu_torch/tools/sched_design_sweep.py [--part s1s2|s3]

The kernel source fixes the choices (``CLUSTER_CHOICES``, ``LEVELS``,
``S3_FUSED``). This script builds copies of it with other values, one
``nvcc`` each, all started together, into ``ray_tpu_torch/_build/sweep/``,
and loads each as its own library. On the inputs of ``chip_smoke.py``'s
phase 12 it holds every copy's output exactly against the plain version,
then times it with CUDA events, in two passes (the copies in order, then
in reverse):

- ``schedule_classes`` at the benchmark's 10,000 nodes x 4, 8 classes, and
  at ``schedule_batch``'s recorded 1,024 x 128, for clusters of 16 and 8
  and 1-3 levels (each launch after a copy of avail, which it updates);
- ``pg_pack`` on ``solve``'s recorded 512 bundles over the 16,384-row
  view under SPREAD, for clusters of 16, 8 and 4;
- ``pg_pack_batch`` (S3) under SPREAD with k = 128 at the benchmark's 64
  groups x 8 bundles over its 10,000 nodes, at ``solve_many``'s recorded
  16,384-row view, at 40,000 and 70,000 nodes, and at 1,024 groups (a
  restart storm) over the 10,000 nodes, for one launch (``S3_FUSED``) and
  two, each with clusters of 16 and 8; beside them each copy's ranking
  alone, and ``torch.sort(stable=True)`` of the same keys into outputs
  allocated once (``torch.argsort``'s own call).

It prints the card's name and power limit, its progress, a table, and one
JSON line; a run stuck for WATCHDOG_S seconds prints every thread's stack
and exits with 1. It needs one CUDA card; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import faulthandler
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from ray_tpu_torch._private import native_loader  # noqa: E402

tp, pk, swl, spol = cs.tp, cs.pk, cs.swl, cs.spol

CLUSTERS_LINE = r"constexpr int CLUSTER_CHOICES\[\] = \{[0-9, ]+\};"
LEVELS_LINE = r"constexpr int LEVELS = [0-9]+;"
FUSED_LINE = r"constexpr bool S3_FUSED = (true|false);"
# (cluster size, levels, S3 fused) of each copy; pg_pack uses the cluster
# size alone, pg_pack_batch the cluster size and the S3 design.
CLASS_VARIANTS = [(c, lv, True) for c in (16, 8) for lv in (1, 2, 3)]
PACK_CLUSTERS = (16, 8, 4)
BATCH_VARIANTS = [(c, 2, fused) for fused in (True, False) for c in (16, 8)]
STORM_GROUPS = 1024
ITERS = 10
WATCHDOG_S = 600


def variant_source(cluster: int, levels: int, fused: bool) -> str:
    with open(os.path.join(native_loader.CSRC_DIR, "scheduler.cu")) as f:
        src = f.read()
    for line, new in ((CLUSTERS_LINE, f"constexpr int CLUSTER_CHOICES[] = "
                                      f"{{{cluster}}};"),
                      (LEVELS_LINE, f"constexpr int LEVELS = {levels};"),
                      (FUSED_LINE, f"constexpr bool S3_FUSED = "
                                   f"{'true' if fused else 'false'};")):
        src, found = re.subn(line, new, src)
        if found != 1:
            raise RuntimeError(f"scheduler.cu holds {found} lines like "
                               f"{line!r}, not one")
    return src


def _bind(lib) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args, res in (
            ("schedule_scratch_floats", [i32, i32], i64),
            ("schedule_classes", [ptr] * 6 + [ctypes.c_float, i32, i32, i32,
                                              ptr, ptr, i64, ptr], i32),
            ("pg_pack", [ptr] * 4 + [i32] * 4 + [ptr] * 3, i32),
            ("pg_pack_batch", [ptr] * 5 + [i32] * 6 + [ptr] * 4, i32),
            ("pg_pack_rank", [ptr] * 3 + [i32] * 3 + [ptr] * 2, i32),
            ("pg_pack_batch_scratch", [i32] * 5 + [ptr], i32),
            ("pg_pack_batch_shape", [i32] * 4 + [ptr], i32),
            ("scheduler_launch_shape", [i32] * 4 + [ptr], i32)):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = res


def build_variants(variants) -> dict:
    """{(cluster, levels, fused): ctypes library} of the copies, built
    together."""
    out_dir = os.path.join(native_loader.BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = native_loader._nvcc()
    sources = {}
    for key in variants:
        cluster, levels, fused = key
        stem = os.path.join(out_dir, f"scheduler_c{cluster}_l{levels}_"
                                     f"{'fused' if fused else 'two'}")
        with open(stem + ".cu", "w") as f:
            f.write(variant_source(*key))
        sources[key] = stem + ".cu"
    procs = {}
    for key, src in sources.items():
        so = os.path.join(out_dir, os.path.basename(src)[:-3] + ".so")
        procs[key] = (so, subprocess.Popen(
            [nvcc, *native_loader.NVCC_FLAGS, "-I", native_loader.CSRC_DIR,
             "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the copy {key}:\n{err}{out}")
        lib = ctypes.CDLL(so)
        _bind(lib)
        libs[key] = lib
    return libs


def launch_shape(lib, program, n, r, b=0) -> dict:
    out = (ctypes.c_longlong * 5)()
    cs.check(lib.scheduler_launch_shape(program, n, r, b, out) == 0,
             "scheduler_launch_shape refused its arguments")
    return dict(zip(("ctas", "threads", "smem_bytes", "slices_in_smem",
                     "clusters_held"), (int(x) for x in out)))


def classes_runner(lib, args, threshold):
    """One schedule_classes launch of this copy on ``args`` (avail, total,
    alive, demands, counts, prefs; avail copied first), and its outputs."""
    avail0, total, alive, demands, counts, prefs = args
    n, r = avail0.shape
    k = demands.shape[0]
    work = avail0.clone()
    packed = torch.empty((k, 4 * n + 5), dtype=torch.int32,
                         device=avail0.device)
    scratch = torch.empty(lib.schedule_scratch_floats(n, k),
                          dtype=torch.float32, device=avail0.device)

    def run():
        work.copy_(avail0)
        rc = lib.schedule_classes(
            work.data_ptr(), total.data_ptr(), alive.data_ptr(),
            demands.data_ptr(), counts.data_ptr(), prefs.data_ptr(),
            float(threshold), n, r, k, packed.data_ptr(), scratch.data_ptr(),
            scratch.numel(), torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"schedule_classes failed: CUDA error {rc}")

    return run, packed, work


def pack_runner(lib, args, mode):
    avail, total, alive, demands = args
    n, r = avail.shape
    b = demands.shape[0]
    work = avail.clone()
    used = torch.zeros(n, dtype=torch.bool, device=avail.device)
    out = torch.empty(b + 1, dtype=torch.int32, device=avail.device)

    def run():
        work.copy_(avail)
        used.zero_()
        rc = lib.pg_pack(
            work.data_ptr(), total.data_ptr(), alive.data_ptr(),
            demands.data_ptr(), n, r, b, pk.MODES[mode], used.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"pg_pack failed: CUDA error {rc}")

    return run, out


def batch_runner(lib, args, rank_only=False):
    """One pg_pack_batch entry (or its ranking alone) of this copy on
    ``args`` (avail, total, alive, demands, valid, mode, k), and its
    output."""
    avail, total, alive, demands, valid, mode, k = args
    n, r = avail.shape
    g, b = demands.shape[0], demands.shape[1]
    dev = avail.device
    sizes = (ctypes.c_longlong * 2)()
    cs.check(lib.pg_pack_batch_scratch(n, r, g, b, k, sizes) == 0,
             "pg_pack_batch_scratch refused its arguments")
    ranked = torch.empty(sizes[0], dtype=torch.int32, device=dev)
    slots = torch.empty(max(sizes[1], 1), dtype=torch.float32, device=dev)
    out = torch.empty((g, b + 1), dtype=torch.int32, device=dev)

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        if rank_only:
            rc = lib.pg_pack_rank(avail.data_ptr(), total.data_ptr(), alive.data_ptr(),
                         n, r, pk.MODES[mode], ranked.data_ptr(), stream)
        else:
            rc = lib.pg_pack_batch(avail.data_ptr(), total.data_ptr(),
                                   alive.data_ptr(), demands.data_ptr(),
                                   valid.data_ptr(), n, r, g, b, k,
                                   pk.MODES[mode], ranked.data_ptr(),
                                   slots.data_ptr(), out.data_ptr(), stream)
        cs.check(rc == 0, f"pg_pack_batch failed: CUDA error {rc}")

    return run, (ranked[:n] if rank_only else out)


def batch_inputs(view):
    """S3's inputs under SPREAD, k = 128: the benchmark's, solve_many's
    recorded view, 40,000 and 70,000 nodes, and STORM_GROUPS groups over
    the benchmark's nodes."""
    dev = torch.device("cuda")

    def on_card(w, demands):
        valid = np.ones(demands.shape[:2], bool)
        return [torch.as_tensor(a).to(dev) for a in (
            w.avail, w.total, w.alive, demands, valid)] + ["spread",
                                                          swl.PG_TOPK]

    w = swl.workload(np.random.RandomState(42))
    w40 = swl.workload(np.random.RandomState(42), 40_000, 1000)
    w70 = swl.workload(np.random.RandomState(42), 70_000, 1000)
    storm = swl.build_pg_groups(np.random.RandomState(7), STORM_GROUPS)
    return {"bench": on_card(w, w.batch_demands), "view": list(view),
            "n40000": on_card(w40, w40.batch_demands),
            "n70000": on_card(w70, w70.batch_demands),
            f"g{STORM_GROUPS}": on_card(w, storm)}


def recorded_inputs():
    """The benchmark's schedule_classes inputs, schedule_batch's, solve's
    and solve_many's, each as the main path hands them to the kernel
    wrappers."""
    dev = torch.device("cuda")
    w = swl.workload(np.random.RandomState(42))
    k = len(w.counts)
    bench = [torch.as_tensor(a).to(dev) for a in (
        w.avail, w.total, w.alive, w.demands, w.counts)]
    bench.append(torch.full((k,), -1, dtype=torch.int32, device=dev))
    cluster_small, _ = cs.sched_cluster(w, cs.SCHED_POLICY_NODES)
    cluster_big, names = cs.sched_cluster(w)
    bundles = [{nm: float(v) for nm, v in zip(names, row) if v > 0}
               for row in w.pg_demands]
    groups = [[{nm: float(v) for nm, v in zip(names, row) if v > 0}
               for row in grp] for grp in w.batch_demands]
    with cs.KernelRecorder() as recorder:
        tp.TpuSchedulingPolicy().schedule_batch(
            cluster_small, cs.sched_requests(w, cluster_small))
        solver = pk.PgKernelSolver()
        solver.solve(cluster_big, bundles, "SPREAD")
        solver.solve_many(cluster_big, groups, "SPREAD")
    torch.cuda.synchronize()
    calls = {name: [c[1] for c in recorder.calls if c[0] == name]
             for name in cs.SCHED_PLAIN}
    cs.check(all(len(c) == 1 for c in calls.values()),
             f"recorded {[len(c) for c in calls.values()]} schedule_batch, "
             f"solve and solve_many kernel calls, not one each")
    batch = calls["schedule_classes_cuda"][0]
    thr = spol.get_config().scheduler_spread_threshold
    classes = {"schedule_classes": (bench, thr),
               "schedule_classes_batch": (list(batch[:6]), batch[6])}
    return classes, calls["pack_cuda"][0][:4], calls["pack_batch_cuda"][0]


def sweep_s3(libs, view, runs, shapes):
    """Every S3 copy on each of batch_inputs, exactly against the plain
    version, each entry and its ranking alone added to ``runs``;
    torch.sort(stable=True) of the same keys beside them."""
    for label, args in batch_inputs(view).items():
        avail, total, alive, demands, valid, mode, k = args
        want = pk.pack_batch_plain(*args)
        want_rank = pk.rank_nodes_plain(avail, total, alive, mode)
        n, r = avail.shape
        for key in BATCH_VARIANTS:
            name = f"C{key[0]}_{'fused' if key[2] else 'two'}"
            run, out = batch_runner(libs[key], args)
            rank, ranked = batch_runner(libs[key], args, rank_only=True)
            run()
            rank()
            torch.cuda.synchronize()
            cs.check(torch.equal(out, want) and torch.equal(
                ranked.long(), want_rank), f"pg_pack_batch at {label} with "
                     f"the copy {name} differs from its plain version")
            shapes[f"pg_pack_batch {label} {name}"] = cs.s3_launch_shape(
                n, r, demands.shape[1], k, libs[key])
            runs.append((f"pg_pack_batch {label}", name, run))
            runs.append((f"pg_pack_batch {label} ranking", name, rank))
            print(f"pg_pack_batch {label} {name}: kernel == plain True",
                  flush=True)
        runs.append((f"pg_pack_batch {label} ranking", "torch.sort",
                     cs.s3_sort_runner(avail, total, alive, mode)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--part", choices=("all", "s1s2", "s3"),
                        default="all", help="the kernels to sweep")
    part = parser.parse_args().part
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    t0 = time.perf_counter()
    s1s2, s3 = part in ("all", "s1s2"), part in ("all", "s3")
    variants = set()
    if s1s2:
        variants |= set(CLASS_VARIANTS) | {(c, 3, True) for c in PACK_CLUSTERS}
    if s3:
        variants |= set(BATCH_VARIANTS)
    libs = build_variants(sorted(variants))
    print(f"built {len(libs)} copies in {time.perf_counter() - t0:.1f} s",
          flush=True)
    classes, pack_args, view = recorded_inputs()
    print("recorded the main path's inputs", flush=True)

    runs, shapes = [], {}
    for label, (args, thr) in classes.items() if s1s2 else ():
        want, want_avail = tp.schedule_classes_plain(
            *(a.clone() for a in args), thr)
        n, r = args[0].shape
        for key in CLASS_VARIANTS:
            run, packed, work = classes_runner(libs[key], args, thr)
            run()
            torch.cuda.synchronize()
            cs.check(torch.equal(packed, want) and torch.equal(work, want_avail),
                     f"{label} with the copy {key} differs from its plain "
                     f"version")
            name = f"C{key[0]}_L{key[1]}"
            shapes[f"{label} {name}"] = launch_shape(libs[key], 0, n, r)
            runs.append((label, name, run))
            print(f"{label} {name}: kernel == plain True", flush=True)
    if s1s2:
        want = pk.pack_plain(*pack_args, "spread")
        n, r = pack_args[0].shape
        for c in PACK_CLUSTERS:
            run, out = pack_runner(libs[(c, 3, True)], pack_args, "spread")
            run()
            torch.cuda.synchronize()
            cs.check(torch.equal(out, want), f"pg_pack with the copy C{c} "
                     f"differs from its plain version")
            shapes[f"pg_pack C{c}"] = launch_shape(
                libs[(c, 3, True)], 1, n, r, pack_args[3].shape[0])
            runs.append(("pg_pack", f"C{c}", run))
            print(f"pg_pack C{c}: kernel == plain True", flush=True)
    if s3:
        sweep_s3(libs, view, runs, shapes)

    table = {}
    for order in (runs, runs[::-1]):
        for label, name, run in order:
            table.setdefault(label, {}).setdefault(name, []).append(
                cs.time_ms(run, ITERS) * 1e3)
    for label, row in table.items():
        print(f"{label} (us, CUDA events, passes in order and reversed, "
              f"all == plain): " + ", ".join(
                  f"{name} {a:.1f} / {b:.1f}" for name, (a, b) in row.items()))
    for key, shape in shapes.items():
        print(f"launch shape {key}: {shape}")
    print(json.dumps({"card": card, "us": table, "launch_shapes": shapes}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
