"""The port's feasibility-fenced admission (the owner's unplaceable-class
ledger): the cases of ``tests/test_scheduler_fence.py`` on
``ray_tpu_torch``. A capacity-fenced class is (a) parked with a TYPED
``CapacityInfeasibleError`` reaching the owner, (b) provably skipped by
subsequent scheduling ticks while the cluster ledger is static (no
per-tick rescan), (c) released and drained as soon as capacity appears,
with the ``ray_tpu_tasks{state=infeasible}`` gauge moving and returning
to zero.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch.exceptions import CapacityInfeasibleError


class _SpyPolicy:
    """Wraps the production policy, recording every batch it sees."""

    def __init__(self, inner):
        self.inner = inner
        self.batches = []

    def schedule_batch(self, cluster, requests):
        self.batches.append(len(requests))
        return self.inner.schedule_batch(cluster, requests)

    def schedule(self, cluster, request):
        return self.inner.schedule(cluster, request)


def _wait(predicate, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


@pytest.fixture
def fence_runtime():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, max_process_workers=2, num_gpus=0)
    try:
        from ray_tpu_torch._private.worker import global_worker
        yield global_worker()
    finally:
        ray_tpu_torch.shutdown()
        get_config().reset()


def test_fenced_class_parked_skipped_and_released(fence_runtime,
                                                  tmp_path):
    w = fence_runtime
    ng = w.node_group
    gate = tmp_path / "gate"

    @ray_tpu_torch.remote(num_cpus=1)
    def blocker(path, started):
        import os
        import time as _t
        with open(started, "w") as f:
            f.write("up")
        while not os.path.exists(path):
            _t.sleep(0.02)
        return "done"

    @ray_tpu_torch.remote(num_cpus=1)
    def quick(i):
        return i

    started = [tmp_path / f"started_{i}" for i in range(2)]
    blockers = [blocker.remote(str(gate), str(s)) for s in started]
    # Both blockers must be EXECUTING (each on its own worker) before
    # the burst arrives: a blocker still pipe-queued behind the other
    # would be stall-stolen back, and the steal's free/re-allocate
    # churn bumps the resource version — legitimately releasing the
    # ledger — which makes the static-window assertion meaningless.
    assert _wait(lambda: all(s.exists() for s in started))
    refs = [quick.remote(i) for i in range(8)]

    # (a) the surplus beyond the totals bound (2) fences and the typed
    # signal reaches the owner
    assert _wait(lambda: ng.unplaceable_size() >= 6)
    report = ng.unplaceable_report()
    assert len(report) == 1
    err = report[0]["error"]
    assert isinstance(err, CapacityInfeasibleError)
    assert err.retryable and err.bound == 2
    assert err.demand == {"CPU": 1.0}
    assert report[0]["pending"] == ng.unplaceable_size()
    assert ng.stats()["unplaceable"] == ng.unplaceable_size()

    # gauge moved: parked infeasible + unplaceable ledger
    from ray_tpu_torch.util import metrics
    lines = [ln for ln in metrics.prometheus_text().splitlines()
             if ln.startswith("ray_tpu_tasks")
             and 'state="infeasible"' in ln]
    assert lines and float(lines[0].split()[-1]) >= 6

    # (b) no per-tick rescan: while the cluster ledger is static, the
    # scheduling loop never feeds the fenced specs back to the policy.
    # Only the un-fenced remainder (<= bound) may keep retrying.
    parked = ng.unplaceable_size()
    fenced_before = ng.num_fenced
    spy = _SpyPolicy(ng._policy)
    ng._policy = spy
    try:
        time.sleep(0.6)        # ~6 ticks of the 100ms scheduler loop
        assert ng.unplaceable_size() == parked       # still parked
        assert ng.num_fenced == fenced_before        # no re-fence churn
        assert all(b <= 8 - parked for b in spy.batches), spy.batches
    finally:
        ng._policy = spy.inner

    # (c) capacity appears (blockers finish -> version delta): the
    # ledger releases and every fenced task completes
    gate.write_text("go")
    assert ray_tpu_torch.get(blockers, timeout=30) == ["done", "done"]
    assert ray_tpu_torch.get(refs, timeout=30) == list(range(8))
    assert ng.unplaceable_size() == 0
    lines = [ln for ln in metrics.prometheus_text().splitlines()
             if ln.startswith("ray_tpu_tasks")
             and 'state="infeasible"' in ln]
    assert lines and float(lines[0].split()[-1]) == 0


def test_totally_infeasible_class_surfaces_typed(fence_runtime):
    """any_feasible False (no node could EVER run one instance): the
    spec parks membership-keyed as before, and the owner's report
    carries the typed error with bound 0."""
    w = fence_runtime
    ng = w.node_group

    @ray_tpu_torch.remote(resources={"FPGA": 1})
    def needs_fpga():
        return 1

    ref = needs_fpga.remote()
    assert _wait(lambda: ng.stats()["infeasible"] == 1)
    report = ng.unplaceable_report()
    hit = [r for r in report if "FPGA" in r["demand"]]
    assert hit and hit[0]["bound"] == 0 and hit[0]["pending"] == 1
    assert isinstance(hit[0]["error"], CapacityInfeasibleError)
    # a node with the resource arrives: the task becomes schedulable
    from ray_tpu_torch._private.scheduler.resources import NodeResources
    from ray_tpu_torch._private.ids import NodeID
    ng.add_node(NodeID.from_random(),
                NodeResources.of(CPU=1, FPGA=1))
    assert ray_tpu_torch.get(ref, timeout=30) == 1
    assert ng.stats()["infeasible"] == 0


def test_cancel_drains_fenced_entry_cleanly(fence_runtime, tmp_path):
    """Regression: cancelling every parked spec of a fenced class must
    drop the ledger entry (no pending=0 ghosts in the report) and keep
    the typed error's pending count live."""
    w = fence_runtime
    ng = w.node_group
    gate = tmp_path / "gate"

    @ray_tpu_torch.remote(num_cpus=1)
    def blocker(path, started):
        import os
        import time as _t
        with open(started, "w") as f:
            f.write("up")
        while not os.path.exists(path):
            _t.sleep(0.02)
        return "done"

    @ray_tpu_torch.remote(num_cpus=1)
    def quick(i):
        return i

    started = [tmp_path / f"started_{i}" for i in range(2)]
    blockers = [blocker.remote(str(gate), str(s)) for s in started]
    assert _wait(lambda: all(s.exists() for s in started))
    refs = [quick.remote(i) for i in range(8)]
    assert _wait(lambda: ng.unplaceable_size() >= 6)
    parked = ng.unplaceable_size()
    fenced_refs = refs[-parked:]
    for r in fenced_refs[:-1]:
        ray_tpu_torch.cancel(r)
    report = ng.unplaceable_report()
    assert report and report[0]["pending"] == 1
    assert report[0]["error"].pending == 1
    ray_tpu_torch.cancel(fenced_refs[-1])
    assert ng.unplaceable_report() == []      # entry dropped, no ghost
    assert ng.unplaceable_size() == 0
    gate.write_text("go")
    assert ray_tpu_torch.get(blockers, timeout=30) == ["done", "done"]
    live = [r for r in refs if r not in fenced_refs]
    assert ray_tpu_torch.get(live, timeout=30) == list(range(len(live)))


def test_fence_disabled_restores_legacy_retry(fence_runtime,
                                              tmp_path):
    """scheduler_fence_enabled=false: fenced results retry every tick
    (legacy), nothing parks in the ledger, work still completes."""
    get_config().apply_system_config({"scheduler_fence_enabled": False})
    w = fence_runtime
    ng = w.node_group
    gate = tmp_path / "gate"

    @ray_tpu_torch.remote(num_cpus=1)
    def blocker(path):
        import os
        import time as _t
        while not os.path.exists(path):
            _t.sleep(0.02)
        return "done"

    @ray_tpu_torch.remote(num_cpus=1)
    def quick(i):
        return i

    blockers = [blocker.remote(str(gate)) for _ in range(2)]
    refs = [quick.remote(i) for i in range(6)]
    time.sleep(0.5)
    assert ng.unplaceable_size() == 0
    gate.write_text("go")
    assert ray_tpu_torch.get(refs, timeout=30) == list(range(6))
    assert ray_tpu_torch.get(blockers, timeout=30) == ["done", "done"]
