"""A queued task's argument that the object store spills after the task
was dispatched: the port's process worker, whose descriptor names a
shared-memory segment that is gone, gets the object through its owner,
whose store restores it. The JAX package's worker raises
``FileNotFoundError`` in the same case (ROADMAP C; both packages spill
their oldest objects first, which a queued task's arguments often are).
Found by a 64 MB repartition on the card, whose 16 partitions of each
block were stored whole."""

import time

import numpy as np

import ray_tpu_torch as rt


def test_queued_task_reads_an_argument_spilled_after_dispatch():
    w = rt.init(num_cpus=2, num_gpus=0, max_process_workers=1,
                object_store_memory=64 << 20)
    try:
        @rt.remote
        def nap(seconds):
            time.sleep(seconds)
            return seconds

        @rt.remote
        def total(a):
            return int(a.sum())

        rt.get(nap.remote(0))                      # the one worker is up
        arg = rt.put(np.ones(10 << 17, np.int64))  # 10 MB in shm
        busy = nap.remote(1.5)                     # holds the worker
        queued = total.remote(arg)                 # dispatched behind it
        time.sleep(0.5)
        # 60 MB more: past the spill threshold, the oldest object (the
        # queued task's argument) goes to disk
        more = [rt.put(np.full(10 << 17, i, np.int64)) for i in range(6)]
        assert rt.get(queued, timeout=60) == 10 << 17
        assert rt.get(busy, timeout=60) == 1.5
        assert w.shm_store.num_spilled >= 1
        assert [int(rt.get(m)[0]) for m in more] == list(range(6))
    finally:
        rt.shutdown()
