#!/usr/bin/env python3
"""Time the scheduler kernels' design choices on one card: the cluster
size and the bisection levels a cluster sum of ``csrc/scheduler.cu``.

Usage, from the root of a checkout:

    python3 ray_tpu_torch/tools/sched_design_sweep.py

The kernel source fixes both choices (``CLUSTER_CHOICES``, ``LEVELS``).
This script builds copies of it with other values, one ``nvcc`` each, all
started together, into ``ray_tpu_torch/_build/sweep/``, and loads each as
its own library. On the inputs of ``chip_smoke.py``'s phase 12 it holds
every copy's output exactly against the plain version, then times it with
CUDA events, in two passes (the copies in order, then in reverse):

- ``schedule_classes`` at the benchmark's 10,000 nodes x 4, 8 classes, and
  at ``schedule_batch``'s recorded 1,024 x 128, for clusters of 16 and 8
  and 1-3 levels (each launch after a copy of avail, which it updates);
- ``pg_pack`` on ``solve``'s recorded 512 bundles over the 16,384-row
  view under SPREAD, for clusters of 16, 8 and 4.

It prints the card's name and power limit, its progress, a table, and one
JSON line; a run stuck for WATCHDOG_S seconds prints every thread's stack
and exits with 1. It needs one CUDA card; it imports nothing of JAX.
"""

from __future__ import annotations

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
# (cluster size, levels) of each copy; pg_pack does not use the levels.
CLASS_VARIANTS = [(c, lv) for c in (16, 8) for lv in (1, 2, 3)]
PACK_CLUSTERS = (16, 8, 4)
ITERS = 10
WATCHDOG_S = 600


def variant_source(cluster: int, levels: int) -> str:
    with open(os.path.join(native_loader.CSRC_DIR, "scheduler.cu")) as f:
        src = f.read()
    for line, new in ((CLUSTERS_LINE, f"constexpr int CLUSTER_CHOICES[] = "
                                      f"{{{cluster}}};"),
                      (LEVELS_LINE, f"constexpr int LEVELS = {levels};")):
        src, found = re.subn(line, new, src)
        if found != 1:
            raise RuntimeError(f"scheduler.cu holds {found} lines like "
                               f"{line!r}, not one")
    return src


def build_variants(variants) -> dict:
    """{(cluster, levels): ctypes library} of the copies, built together."""
    out_dir = os.path.join(native_loader.BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = native_loader._nvcc()
    procs = {}
    for cluster, levels in variants:
        stem = os.path.join(out_dir, f"scheduler_c{cluster}_l{levels}")
        with open(stem + ".cu", "w") as f:
            f.write(variant_source(cluster, levels))
        procs[(cluster, levels)] = (stem + ".so", subprocess.Popen(
            [nvcc, *native_loader.NVCC_FLAGS, "-I", native_loader.CSRC_DIR,
             "-o", stem + ".so", stem + ".cu"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the copy {key}:\n{err}{out}")
        lib = ctypes.CDLL(so)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.schedule_scratch_floats.argtypes = [i32, i32]
        lib.schedule_scratch_floats.restype = ctypes.c_longlong
        lib.schedule_classes.argtypes = (
            [ptr] * 6 + [ctypes.c_float, i32, i32, i32, ptr, ptr,
                         ctypes.c_longlong, ptr])
        lib.schedule_classes.restype = i32
        lib.pg_pack.argtypes = [ptr] * 4 + [i32] * 4 + [ptr] * 3
        lib.pg_pack.restype = i32
        lib.scheduler_launch_shape.argtypes = [i32] * 4 + [ptr]
        lib.scheduler_launch_shape.restype = i32
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


def recorded_inputs():
    """The benchmark's schedule_classes inputs, schedule_batch's and
    solve's, each as the main path hands them to the kernel wrappers."""
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
    with cs.KernelRecorder() as recorder:
        tp.TpuSchedulingPolicy().schedule_batch(
            cluster_small, cs.sched_requests(w, cluster_small))
        pk.PgKernelSolver().solve(cluster_big, bundles, "SPREAD")
    torch.cuda.synchronize()
    batch = [c[1] for c in recorder.calls if c[0] == "schedule_classes_cuda"]
    pack = [c[1] for c in recorder.calls if c[0] == "pack_cuda"]
    cs.check(len(batch) == 1 and len(pack) == 1,
             f"recorded {len(batch)} schedule_batch and {len(pack)} solve "
             f"kernel calls, not one each")
    thr = spol.get_config().scheduler_spread_threshold
    classes = {"schedule_classes": (bench, thr),
               "schedule_classes_batch": (list(batch[0][:6]), batch[0][6])}
    return classes, pack[0][:4]


def main() -> int:
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
    variants = sorted(set(CLASS_VARIANTS) | {(c, 3) for c in PACK_CLUSTERS})
    libs = build_variants(variants)
    print(f"built {len(libs)} copies in {time.perf_counter() - t0:.1f} s",
          flush=True)
    classes, pack_args = recorded_inputs()
    print("recorded the main path's inputs", flush=True)

    runs, shapes = [], {}
    for label, (args, thr) in classes.items():
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
    want = pk.pack_plain(*pack_args, "spread")
    n, r = pack_args[0].shape
    for c in PACK_CLUSTERS:
        run, out = pack_runner(libs[(c, 3)], pack_args, "spread")
        run()
        torch.cuda.synchronize()
        cs.check(torch.equal(out, want), f"pg_pack with the copy C{c} "
                 f"differs from its plain version")
        shapes[f"pg_pack C{c}"] = launch_shape(libs[(c, 3)], 1, n, r,
                                               pack_args[3].shape[0])
        runs.append(("pg_pack", f"C{c}", run))
        print(f"pg_pack C{c}: kernel == plain True", flush=True)

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
