#!/usr/bin/env python3
"""Where S3's time goes on one card: ``%globaltimer`` stamps in a copy of
``csrc/scheduler.cu``.

Usage, from the root of a checkout:

    python3 ray_tpu_torch/tools/sched_s3_timeline.py

It copies the source, inserts stamps at fixed lines of
``pg_pack_batch_cluster`` (thread 0 of every CTA) and of ``solve_group``
(lane 0 of group 0's warp), builds the copy with ``nvcc`` into
``ray_tpu_torch/_build/dbg/``, runs ``pg_pack_batch`` under SPREAD with
k = 128 on the benchmark's 64 groups x 8 bundles over its 10,000 nodes
and on 1,024 groups, checks each output exactly against the plain
version, and prints, for the last of 5 runs, the µs from the first CTA's
start at which each step ended: in the ranking, for CTA 0 and the latest
CTA; in the groups, group 0's gather, and its first two bundles' scoring,
reduction, commit and marking. The stamps cost a few instructions each,
so the total reads a little above the kernels' own time. A stamped line
that is missing stops it with its text. It needs one CUDA card and
imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from ray_tpu_torch._private import native_loader  # noqa: E402

pk, swl = cs.pk, cs.swl

RANK_STEPS = ("start", "keys", "sorted", "armed", "pushes in", "merged",
              "order written")
GROUP_STEPS = ("gathered", "b0 scored", "b0 reduced", "b0 committed",
               "b0 marked", "b1 scored", "b1 reduced", "b1 committed",
               "b1 marked", "done")
GROUPS = 256        # first stamp slot of group 0's warp


def _stamp(slot: str, who: str) -> str:
    return (f"{{ if ({who}) {{ unsigned long long t_; asm volatile("
            f"\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
            f"g_stamp[{slot}] = t_; }} }}")


def stamped_source() -> str:
    with open(os.path.join(native_loader.CSRC_DIR, "scheduler.cu")) as f:
        src = f.read()
    cta = "threadIdx.x == 0"

    def rank(i):
        return _stamp(f"16 * cluster.block_rank() + {i}", cta)

    def group(i, more=""):
        return _stamp(f"{GROUPS} + {i}", f"threadIdx.x == 0 && grp == 0{more}")

    bundle = " && bi < 2"
    marks = [
        ("  float* util_of = reinterpret_cast<float*>(ranked + "
         "order_ints(n));", rank(0) + "\n", ""),
        ("  sort_slice(skey, cnt, S);\n  int len[MAX_C];",
         "  __syncthreads();" + rank(1) + "\n", ""),
        ("\n  int len[MAX_C];\n  peer_lengths(n, per, rank, C, len);\n"
         "  if (STAGED)", "\n" + rank(2), ""),
        ("    cluster_wait();\n", "", rank(3) + "\n"),
        ("    if (C > 1) mbar_wait(&stage_bar, 0);\n", "", rank(4) + "\n"),
        ("  cluster.sync();  // the order written, every push landed\n",
         "  __syncthreads();" + rank(5) + "\n", rank(6) + "\n"),
        ("  // Within a group, slots hold distinct nodes",
         group(0) + "\n", ""),
        ("    const unsigned hi = __reduce_min_sync",
         group("1 + 4 * bi", bundle) + "\n", ""),
        ("    const int w = static_cast<int>(lo);\n", "",
         group("2 + 4 * bi", bundle) + "\n"),
        ("    ok = __shfl_sync(FULL, static_cast<int>(ok), w & 31) != 0;\n",
         "", group("3 + 4 * bi", bundle) + "\n"),
        ("SLOT_USED;\n    }\n", "", group("4 + 4 * bi", bundle) + "\n"),
        ("  if (lane == 0) row[b] = all_ok;\n", "", group(9) + "\n"),
    ]
    for line, before, after in marks:
        if src.count(line) != 1:
            raise RuntimeError(f"scheduler.cu holds {src.count(line)} lines "
                               f"like {line!r}, not one")
        src = src.replace(line, before + line + after)
    src = src.replace("namespace {\n",
                      "__device__ unsigned long long g_stamp[512];\n"
                      "namespace {\n", 1)
    return src + """
extern "C" int read_stamps(unsigned long long* host) {
  return cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp));
}
extern "C" int clear_stamps() {
  static unsigned long long zero[512];
  return cudaMemcpyToSymbol(g_stamp, zero, sizeof(zero));
}
"""


def build() -> ctypes.CDLL:
    out_dir = os.path.join(native_loader.BUILD_DIR, "dbg")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = (os.path.join(out_dir, f"scheduler_stamped.{e}")
              for e in ("cu", "so"))
    with open(cu, "w") as f:
        f.write(stamped_source())
    subprocess.run([native_loader._nvcc(), *native_loader.NVCC_FLAGS,
                    "-I", native_loader.CSRC_DIR, "-o", so, cu], check=True,
                   capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(so)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pg_pack_batch.argtypes = [ptr] * 5 + [i32] * 6 + [ptr] * 4
    lib.pg_pack_batch_scratch.argtypes = [i32] * 5 + [ptr]
    for fn in (lib.read_stamps, lib.clear_stamps):
        fn.restype = i32
    lib.read_stamps.argtypes = [ptr]
    return lib


def timeline(lib, label, demands_np, w):
    dev = torch.device("cuda")
    avail, total, alive, demands = (torch.as_tensor(a).to(dev) for a in (
        w.avail, w.total, w.alive, demands_np))
    valid = torch.ones(demands.shape[:2], dtype=torch.bool, device=dev)
    n, r = avail.shape
    g, b = demands.shape[:2]
    k = swl.PG_TOPK
    sizes = (ctypes.c_longlong * 2)()
    cs.check(lib.pg_pack_batch_scratch(n, r, g, b, k, sizes) == 0,
             "pg_pack_batch_scratch refused its arguments")
    ranked = torch.empty(sizes[0], dtype=torch.int32, device=dev)
    slots = torch.empty(max(sizes[1], 1), dtype=torch.float32, device=dev)
    out = torch.empty((g, b + 1), dtype=torch.int32, device=dev)
    want = pk.pack_batch_plain(avail, total, alive, demands, valid, "spread",
                               k)
    for _ in range(5):
        cs.check(lib.clear_stamps() == 0, "clear_stamps failed")
        rc = lib.pg_pack_batch(
            avail.data_ptr(), total.data_ptr(), alive.data_ptr(),
            demands.data_ptr(), valid.data_ptr(), n, r, g, b, k,
            pk.MODES["spread"], ranked.data_ptr(), slots.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        cs.check(rc == 0 and torch.equal(out, want),
                 f"the stamped copy differs from the plain version at {label}")
    raw = (ctypes.c_ulonglong * 512)()
    cs.check(lib.read_stamps(raw) == 0, "read_stamps failed")
    st = np.array(raw, dtype=np.int64)
    ranks = st[:GROUPS].reshape(16, 16)[:, :len(RANK_STEPS)]
    live = ranks[:, 0] > 0
    t0 = ranks[live, 0].min()
    first = (ranks[0] - t0) / 1e3
    last = (ranks[live].max(axis=0) - t0) / 1e3
    grp = (st[GROUPS:GROUPS + len(GROUP_STEPS)] - t0) / 1e3
    print(f"{label} ({n} nodes, {g} x {b} bundles, k {k}): the ranking, "
          f"us from the first CTA's start (CTA 0 / the latest of "
          f"{int(live.sum())}): " + ", ".join(
              f"{s} {a:.2f} / {z:.2f}"
              for s, a, z in zip(RANK_STEPS, first, last)))
    print(f"{label}: group 0's warp, us from the same start: " + ", ".join(
        f"{s} {x:.2f}" for s, x in zip(GROUP_STEPS, grp)))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    lib = build()
    w = swl.workload(np.random.RandomState(42))
    timeline(lib, "the benchmark's shape", w.batch_demands, w)
    timeline(lib, "1,024 groups", swl.build_pg_groups(
        np.random.RandomState(7), 1024), w)
    return 0


if __name__ == "__main__":
    sys.exit(main())
