"""An ObjectRef that the cyclic garbage collector finalizes frees its
object on the thread that ran the collection, which may hold a store's
lock at that moment (a collection can start at any allocation inside a
critical section). The release must not wait on that lock forever: with
the shm store's plain lock, ``put`` on an ingress thread and the
driver's ``shutdown`` both hung. The scenario runs in a child process
under a timeout, so that a regression fails here instead of hanging the
test run."""

import subprocess
import sys

import pytest

SCENARIO = r'''
import gc, sys, threading
import numpy as np
import torch
import ray_tpu_torch as rt

store = sys.argv[1]
w = rt.init(num_cpus=1, num_gpus=0, max_process_workers=1)
value = (np.zeros(1 << 18, np.uint8) if store == "shm_store"   # a segment
         else torch.zeros(16))                                # the tensor
ref = rt.put(value)
oid = ref.id()
cycle = [ref]
cycle.append(cycle)              # only the cyclic collector frees it
del ref, cycle
done = threading.Event()

def collect_inside_the_lock():
    with getattr(w, store)._lock:
        gc.collect()             # the ref's __del__ frees through the store
    done.set()

t = threading.Thread(target=collect_inside_the_lock, daemon=True)
t.start()
t.join(timeout=20)
assert done.is_set(), "the release waited on the store's own lock"
assert not w.memory_store.contains(oid)
assert not getattr(w, store).contains(oid)
rt.shutdown()
print("released")
'''


@pytest.mark.parametrize("store", ["shm_store", "device_store"])
def test_gc_release_inside_a_store_lock(store):
    try:
        out = subprocess.run([sys.executable, "-c", SCENARIO, store],
                             capture_output=True, text=True, timeout=90)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the scenario hung: a release waited on {store}'s lock")
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("released")
