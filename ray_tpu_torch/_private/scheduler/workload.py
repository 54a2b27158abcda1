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
