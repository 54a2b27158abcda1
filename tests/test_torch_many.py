"""The port's scale envelope: the cases of ``tests/test_many.py`` on
``ray_tpu_torch`` — many tasks, actors, placement groups, async actor
calls and shuffle blocks through the live runtime (scheduler, raylets,
worker pools) on resources without a card, with the reference's
throughput and latency floors and a JSONL record per run.

Two tiers:
- default (suite): scaled-down counts, bounded wall-clock;
- opt-in (``RAY_TPU_STRESS=1``): full scale — 50k tasks, 1k actors,
  200 PGs. Records land in ``RAY_TPU_STRESS_OUT`` (default
  ``rtpt_stress.jsonl`` in the temporary directory).
"""

import json
import os
import tempfile
import time

import numpy as np
import pytest

import ray_tpu_torch

STRESS = bool(os.environ.get("RAY_TPU_STRESS"))
_OUT = os.environ.get("RAY_TPU_STRESS_OUT",
                      os.path.join(tempfile.gettempdir(), "rtpt_stress.jsonl"))


def _record(kind: str, fields: dict) -> None:
    rec = {"suite": "many", "kind": kind, "stress_tier": STRESS,
           "ts": time.time(), **fields}
    try:
        with open(_OUT, "a") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError:
        pass


@pytest.fixture
def rt():
    w = ray_tpu_torch.init(num_cpus=8, num_gpus=8, max_process_workers=3)
    yield w
    ray_tpu_torch.shutdown()


def test_many_tasks(rt):
    """Tiny-task wave through the full submit→schedule→lease→execute→
    complete path; asserts sustained throughput and a sane p99."""
    n = 50_000 if STRESS else 4_000

    @ray_tpu_torch.remote(num_gpus=0.001)
    def tiny(i):
        return i

    # warm the in-process lane
    ray_tpu_torch.get([tiny.remote(i) for i in range(16)])
    t0 = time.perf_counter()
    refs = [tiny.remote(i) for i in range(n)]
    submit_s = time.perf_counter() - t0
    out = ray_tpu_torch.get(refs)
    total_s = time.perf_counter() - t0
    assert out[-1] == n - 1
    rate = n / total_s
    _record("many_tasks", {"n": n, "submit_s": round(submit_s, 3),
                           "total_s": round(total_s, 3),
                           "tasks_per_sec": round(rate, 1)})
    assert rate > 150, f"task throughput collapsed: {rate:.0f}/s"

    # round-trip latency under load: p99 of serial round trips with the
    # runtime still warm
    lats = []
    for i in range(50):
        t1 = time.perf_counter()
        ray_tpu_torch.get(tiny.remote(i))
        lats.append(time.perf_counter() - t1)
    p99 = float(np.percentile(np.array(lats), 99))
    _record("task_rt_under_warm_runtime", {"p99_s": round(p99, 4)})
    assert p99 < 5.0, p99


def test_many_actors(rt):
    """Actor swarm: create N in-process actors, one call each, kill
    all. Exercises GCS registry, dedicated leases, per-actor queues."""
    n = 1_000 if STRESS else 200

    @ray_tpu_torch.remote(num_cpus=0.001, num_gpus=0.001)
    class A:
        def __init__(self, i):
            self.i = i

        def who(self):
            return self.i

    t0 = time.perf_counter()
    actors = [A.remote(i) for i in range(n)]
    refs = [a.who.remote() for a in actors]
    got = ray_tpu_torch.get(refs)
    create_call_s = time.perf_counter() - t0
    assert got == list(range(n))
    rate = n / create_call_s
    t1 = time.perf_counter()
    for a in actors:
        ray_tpu_torch.kill(a)
    kill_s = time.perf_counter() - t1
    _record("many_actors", {"n": n,
                            "create_plus_call_s": round(create_call_s, 3),
                            "actors_per_sec": round(rate, 1),
                            "kill_s": round(kill_s, 3)})
    assert rate > 10, f"actor creation rate collapsed: {rate:.0f}/s"


def test_many_placement_groups(rt):
    """PG churn: create/ready/remove many small gangs through the
    2-phase reserve/commit path on the live resource ledger."""
    from ray_tpu_torch.util.placement_group import placement_group
    n = 200 if STRESS else 50

    t0 = time.perf_counter()
    pgs = []
    for i in range(n):
        pg = placement_group([{"CPU": 0.01}], strategy="PACK")
        pgs.append(pg)
    ray_tpu_torch.get([pg.ready() for pg in pgs], timeout=120)
    create_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    from ray_tpu_torch.util.placement_group import remove_placement_group
    for pg in pgs:
        remove_placement_group(pg)
    remove_s = time.perf_counter() - t1
    rate = n / create_s
    _record("many_pgs", {"n": n, "create_s": round(create_s, 3),
                         "pgs_per_sec": round(rate, 1),
                         "remove_s": round(remove_s, 3)})
    assert rate > 5, f"pg creation rate collapsed: {rate:.0f}/s"


def test_many_async_actor_calls(rt):
    """One async actor absorbing a large call wave through the batched
    wire path — the per-actor ceiling, not the scheduler's."""
    n = 30_000 if STRESS else 6_000

    @ray_tpu_torch.remote
    class C:
        def __init__(self):
            self.n = 0

        async def ping(self):
            self.n += 1
            return self.n

    c = C.remote()
    ray_tpu_torch.get(c.ping.remote())
    t0 = time.perf_counter()
    refs = [c.ping.remote() for _ in range(n)]
    assert ray_tpu_torch.get(refs)[-1] == n + 1
    rate = n / (time.perf_counter() - t0)
    _record("many_async_actor_calls", {"n": n,
                                       "calls_per_sec": round(rate, 1)})
    assert rate > 1_000, f"async actor path collapsed: {rate:.0f}/s"


def test_many_shuffle_blocks(rt):
    """1k-block random_shuffle through the two-level plane: completes
    under the byte-backpressure budgets with peak live refs bounded at
    O(N^1.5), nowhere near one-level N^2."""
    import threading

    from ray_tpu_torch import data as rdata
    from ray_tpu_torch._private.worker import global_worker

    n_blocks = 1_000 if STRESS else 128
    rows_per = 4
    rc = global_worker().reference_counter
    peak = {"owned": 0}
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            peak["owned"] = max(peak["owned"], rc.stats()["num_owned"])
            time.sleep(0.05)

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    t0 = time.perf_counter()
    try:
        ds = rdata.range(n_blocks * rows_per,
                         parallelism=n_blocks).random_shuffle(seed=5)
        total = ds.count()
    finally:
        stop.set()
        t.join(timeout=10)
    dt = time.perf_counter() - t0
    assert total == n_blocks * rows_per
    # one-level would be >= n_blocks^2 intermediates (1M at 1k);
    # two-level is G*n ~ n^1.5 (~32k) plus inputs/outputs
    bound = int(3 * n_blocks ** 1.5) + 5 * n_blocks + 1000
    assert peak["owned"] < bound, (peak, bound)
    _record("many_shuffle_blocks", {
        "n_blocks": n_blocks, "total_s": round(dt, 2),
        "peak_live_refs": peak["owned"],
        "n2_would_be": n_blocks * n_blocks})
