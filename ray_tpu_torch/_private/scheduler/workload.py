"""The scheduling benchmark's workload: the JAX package's own figures.

A copy of the array builders of ``bench.py`` (:20-47, :253-262,
:305-316), drawing the same numbers in the same order from one
``np.random.RandomState``, so that ``workload(np.random.RandomState(42))``
gives the arrays the reference benchmarks: 10,000 nodes x 4 resources
(CPU, TPU, memory, custom), 8 demand classes over 1,000,000 tasks, one
placement group of 512 bundles, and 64 groups of 8 bundles.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

N_NODES = 10_000
N_TASKS = 1_000_000
N_CLASSES = 8
N_RES = 4                      # CPU, TPU, memory, custom
PG_BUNDLES = 512               # bench_pg_pack
PG_GROUPS, PG_GROUP_BUNDLES, PG_TOPK = 64, 8, 128   # bench_pg_pack_batched


class Workload(NamedTuple):
    avail: np.ndarray          # [N, R] f32
    total: np.ndarray          # [N, R] f32
    alive: np.ndarray          # [N] bool
    demands: np.ndarray        # [K, R] f32
    counts: np.ndarray         # [K] int32
    pg_demands: np.ndarray     # [B, R] f32
    batch_demands: np.ndarray  # [G, B, R] f32


def build_cluster_arrays(rng, n_nodes: int = N_NODES):
    total = np.zeros((n_nodes, N_RES), np.float32)
    total[:, 0] = rng.choice([256, 256, 384], n_nodes)           # CPU
    total[:, 1] = rng.choice([0, 4, 8, 8], n_nodes)              # TPU
    total[:, 2] = rng.choice([256, 512, 1024], n_nodes)          # memory GB
    total[:, 3] = rng.choice([0, 0, 0, 1], n_nodes)              # custom
    used_frac = rng.uniform(0.0, 0.15, (n_nodes, 1)).astype(np.float32)
    avail = np.maximum(total * (1.0 - used_frac), 0.0)
    alive = np.ones(n_nodes, bool)
    return avail, total, alive


def build_demand_classes(rng, n_tasks: int = N_TASKS):
    demands = np.zeros((N_CLASSES, N_RES), np.float32)
    demands[:, 0] = rng.choice([1, 1, 1, 2], N_CLASSES)          # CPU
    demands[:4, 1] = rng.choice([0, 1], 4)                       # some want TPU
    demands[:, 2] = rng.choice([1, 2, 4], N_CLASSES)             # memory
    class_of_task = rng.randint(0, N_CLASSES, n_tasks).astype(np.int32)
    counts = np.bincount(class_of_task, minlength=N_CLASSES).astype(np.int32)
    return demands, counts, class_of_task


def build_pg_bundles(rng, n_bundles: int = PG_BUNDLES):
    demands = np.zeros((n_bundles, N_RES), np.float32)
    demands[:, 0] = rng.choice([1, 2, 4], n_bundles)     # CPU
    demands[:, 2] = rng.choice([1, 2], n_bundles)        # memory
    return demands


def build_pg_groups(rng, groups: int = PG_GROUPS,
                    bundles: int = PG_GROUP_BUNDLES):
    demands = np.zeros((groups, bundles, N_RES), np.float32)
    demands[:, :, 0] = rng.choice([1, 2, 4], (groups, bundles))     # CPU
    demands[:, :, 2] = rng.choice([1, 2], (groups, bundles))        # memory
    return demands


def workload(rng, n_nodes: int = N_NODES, n_tasks: int = N_TASKS
             ) -> Workload:
    """Every array of the benchmark, drawn in ``bench.py``'s order."""
    avail, total, alive = build_cluster_arrays(rng, n_nodes)
    demands, counts, _ = build_demand_classes(rng, n_tasks)
    return Workload(avail, total, alive, demands, counts,
                    build_pg_bundles(rng), build_pg_groups(rng))


# --------------------------------------------------------------------------
# Edge shapes of the scheduler kernels
# --------------------------------------------------------------------------

class ClassCase(NamedTuple):
    """One ``schedule_classes`` input: fp32 avail and total [N, R], bool
    alive [N], fp32 demands [K, R], int32 counts and prefs [K]."""
    name: str
    avail: np.ndarray
    total: np.ndarray
    alive: np.ndarray
    demands: np.ndarray
    counts: np.ndarray
    prefs: np.ndarray


class PackCase(NamedTuple):
    """One ``pg_pack`` input: avail, total, alive as above, fp32 demands
    [B, R], and the strategy's mode."""
    name: str
    avail: np.ndarray
    total: np.ndarray
    alive: np.ndarray
    demands: np.ndarray
    mode: str


def _cluster(rng, n, r, dead=0.0, used=0.6):
    total = np.zeros((n, r), np.float32)
    total[:, 0] = rng.choice([0.9, 4, 8, 16, 32], n)
    if r > 1:
        total[:, 1:] = rng.choice([0, 0, 1, 4, 64], (n, r - 1))
    avail = (total * (1 - rng.uniform(0, used, (n, 1)))).astype(np.float32)
    alive = rng.rand(n) >= dead
    return avail, total, alive


def _classes(rng, n, r, k, pad_to=None, pref_share=0.4, tasks=3000):
    demands = np.zeros((k, r), np.float32)
    demands[:, 0] = rng.choice([0.3, 0.5, 1, 2], k)
    if r > 1:   # a few of the other resources, so that most classes fit
        demands[:, 1:min(r, 4)] = rng.choice([0, 0, 0, 0.5, 1],
                                             (k, min(r, 4) - 1))
    counts = rng.randint(1, tasks, k).astype(np.int32)
    prefs = np.where(rng.rand(k) < pref_share, rng.randint(0, n, k),
                     -1).astype(np.int32)
    if pad_to is not None and pad_to > k:   # zero-count padding classes
        demands = np.pad(demands, ((0, pad_to - k), (0, 0)))
        counts = np.pad(counts, (0, pad_to - k))
        prefs = np.pad(prefs, (0, pad_to - k), constant_values=-1)
    return demands, counts, prefs


# (name, nodes, resources, classes, padded to, dead share, seed)
_CLASS_SHAPES = (
    ("n1", 1, 4, 3, 4, 0.0, 1), ("n33", 33, 4, 5, 8, 0.2, 2),
    ("n1000", 1000, 4, 8, 8, 0.0, 3), ("n10007", 10007, 4, 8, 8, 0.05, 4),
    ("n70000_global", 70000, 4, 4, 4, 0.0, 5),
    ("r1", 500, 1, 4, 4, 0.0, 6), ("r64", 300, 64, 6, 8, 0.1, 7),
    ("r64_global", 5000, 64, 3, 4, 0.0, 8),
    ("dead_rows", 2000, 8, 12, 16, 0.3, 9))
CLASS_EDGE_NAMES = tuple(s[0] for s in _CLASS_SHAPES) + ("identical_rows",
                                                          "residual")

# (name, rows, resources, bundles, dead share, seed), each in three modes
_PACK_SHAPES = (
    ("n1", 1, 4, 5, 0.0, 11), ("n33", 33, 4, 40, 0.2, 12),
    ("n10007", 10007, 4, 256, 0.05, 13), ("r1", 700, 1, 64, 0.0, 14),
    ("r64_global", 20000, 64, 48, 0.1, 15),
    ("dead_rows", 4096, 4, 128, 0.5, 16))
_MODES = ("pack", "spread", "strict_spread")
PACK_EDGE_NAMES = tuple(f"{s[0]}_{m}" for s in _PACK_SHAPES for m in _MODES) \
    + tuple(f"identical_rows_{m}" for m in _MODES) \
    + ("fit_nowhere_spread", "strict_more_than_alive")


def class_edge_case(name: str) -> ClassCase:
    """One of the shapes (CLASS_EDGE_NAMES) that exercise each branch of
    the ``schedule_classes`` kernel: slices of one node and of odd sizes,
    slices past the shared memory (kept in global memory), one and 64
    resources, dead rows, identical rows (ties
    broken by index), the residual pass and zero-count padded classes.
    Sums stay below 2^24, where placements are exact in any order."""
    for shape_name, n, r, k, pad, dead, seed in _CLASS_SHAPES:
        if shape_name == name:
            rng = np.random.RandomState(seed)
            avail, total, alive = _cluster(rng, n, r, dead)
            demands, counts, prefs = _classes(rng, n, r, k, pad,
                                              tasks=max(4, 3 * n))
            return ClassCase(name, avail, total, alive, demands, counts,
                             prefs)
    rng = np.random.RandomState(10)
    if name == "identical_rows":
        n, r = 777, 4
        total = np.tile(np.array([[16, 4, 64, 0]], np.float32), (n, 1))
        demands, counts, prefs = _classes(rng, n, r, 6, 8, tasks=2 * n)
        return ClassCase(name, total.copy(), total, np.ones(n, bool),
                         demands, counts, prefs)
    if name == "residual":
        # 0.9-CPU nodes against a 0.3-CPU class: each node admits 3 (the
        # totals bound rounds 0.9 + EPS up) but the fill places 2 (0.9 /
        # 0.3 rounds down), so the residual pass runs
        # (tests/test_torch_scheduler.py::test_residual_pass, at scale)
        n = 3000
        total = np.zeros((n, 4), np.float32)
        total[:, 0] = 0.9
        demands = np.zeros((4, 4), np.float32)
        demands[:, 0] = [0.3, 0.1, 0.3, 0]
        return ClassCase(name, total.copy(), total, np.arange(n) < n - 7,
                         demands, np.array([3 * n, 500, 40, 0], np.int32),
                         np.array([-1, 2, 5, -1], np.int32))
    raise KeyError(name)


def class_edge_cases():
    return [class_edge_case(name) for name in CLASS_EDGE_NAMES]


def pack_edge_case(name: str) -> PackCase:
    """One of the ``pg_pack`` shapes (PACK_EDGE_NAMES): one row, odd
    sizes, rows past the shared memory, identical and dead rows, bundles
    that fit nowhere, and STRICT_SPREAD with more bundles than alive
    rows."""
    for shape_name, n, r, b, dead, seed in _PACK_SHAPES:
        for mode in _MODES:
            if f"{shape_name}_{mode}" == name:
                rng = np.random.RandomState(seed)
                avail, total, alive = _cluster(rng, n, r, dead)
                demands = np.zeros((b, r), np.float32)
                demands[:, 0] = rng.choice([0.5, 1, 2, 4], b)
                if r > 2:
                    demands[:, 2] = rng.choice([0, 1, 4], b)
                return PackCase(name, avail, total, alive, demands, mode)
    rng = np.random.RandomState(17)
    if name.startswith("identical_rows_"):
        n = 600
        total = np.tile(np.array([[8, 0, 32, 1]], np.float32), (n, 1))
        demands = np.tile(np.array([[1, 0, 2, 0]], np.float32), (300, 1))
        return PackCase(name, total.copy(), total, np.ones(n, bool), demands,
                        name[len("identical_rows_"):])
    avail, total, alive = _cluster(rng, 900, 4)
    if name == "fit_nowhere_spread":
        nowhere = np.tile(np.array([[1000, 0, 0, 0]], np.float32), (20, 1))
        nowhere[::3, 0] = 1.0       # some fit, the rest fit nowhere
        return PackCase(name, avail, total, alive, nowhere, "spread")
    if name == "strict_more_than_alive":
        alive = np.zeros(900, bool)
        alive[rng.choice(900, 25, replace=False)] = True
        small = np.tile(np.array([[0.5, 0, 0, 0]], np.float32), (60, 1))
        return PackCase(name, avail, total, alive, small, "strict_spread")
    raise KeyError(name)


def pack_edge_cases():
    return [pack_edge_case(name) for name in PACK_EDGE_NAMES]
