"""The port's cluster autoscalers (``ray_tpu_torch.autoscaler`` and
``autoscaler.v2``): the 2 cases of ``tests/test_autoscaler.py`` and the
12 of ``tests/test_autoscaler_v2.py`` on ``ray_tpu_torch`` (the 8-TPU
gang as 8 GPUs on a logical node, whose tasks run on driver threads),
then:

- the two packages' bin matching (``_pick_node_type``) and capacity
  subtraction (``_subtract_capacity``) on 50 seeded random catalogs,
  clusters and demand sets, with ``TPU`` renamed ``GPU``, deciding
  alike;
- a remote GPU node type refused when a scaler is built (a remote
  raylet sees no card), with ``Cluster.add_node``'s message;
- the ``ray_tpu_autoscaler_*`` gauges following one launch and one
  idle termination of a logical GPU node.

``test_v2_anti_oscillation_composition`` samples until both loops have
scaled (its cap is 60 s where the reference's is 8 s), so it waits for
the event it asserts on.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.autoscaler import (
    Autoscaler,
    ClusterNodeProvider,
    NodeType,
)
from ray_tpu_torch.autoscaler.v2 import (AutoscalerV2, FakeCloudProvider,
                                         InstanceState)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it. Imported
    here, not at the top: a process worker that unpickles this module's
    functions then loads no torch."""
    import torch
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def ray_start_cluster():
    """The reference's fixture on the port: a CPU-only head (no card
    here) plus a helper for adding nodes."""
    from ray_tpu_torch.cluster_utils import Cluster
    cluster = Cluster(num_gpus=0, head_num_cpus=4)
    yield cluster
    cluster.shutdown()


def test_autoscaler_launches_for_infeasible_demand(ray_start_cluster):
    cluster = ray_start_cluster
    provider = ClusterNodeProvider(cluster)
    scaler = Autoscaler(
        provider,
        [NodeType("gpuish", {"CPU": 2, "SCALE": 2}, max_workers=2)],
        idle_timeout_s=1.5, period_s=0.1).start()
    try:
        @ray_tpu_torch.remote(num_cpus=1, resources={"SCALE": 1})
        def need_scale(x):
            return x * 2

        # Infeasible now: no node has SCALE. The autoscaler must add one.
        refs = [need_scale.remote(i) for i in range(4)]
        assert ray_tpu_torch.get(refs, timeout=90) == [0, 2, 4, 6]
        assert scaler.num_launched >= 1
        assert scaler.stats()["managed_nodes"] >= 1

        # After the work drains the node goes idle and is reaped.
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if scaler.stats()["managed_nodes"] == 0:
                break
            time.sleep(0.2)
        assert scaler.stats()["managed_nodes"] == 0
        assert scaler.num_terminated >= 1
    finally:
        scaler.stop()


def test_autoscaler_respects_max_workers(ray_start_cluster):
    cluster = ray_start_cluster
    provider = ClusterNodeProvider(cluster)
    scaler = Autoscaler(
        provider,
        [NodeType("cap", {"CPU": 1, "CAPPED": 1}, max_workers=1)],
        idle_timeout_s=60, period_s=0.05).start()
    try:
        @ray_tpu_torch.remote(num_cpus=1, resources={"CAPPED": 1})
        def slow(i):
            time.sleep(0.5)
            return i

        refs = [slow.remote(i) for i in range(4)]
        assert sorted(ray_tpu_torch.get(refs, timeout=90)) == [0, 1, 2, 3]
        assert scaler.stats()["managed_nodes"] == 1   # capped at 1
    finally:
        scaler.stop()


def _wait(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        result = pred()
        if result:
            return result
        time.sleep(0.05)
    return pred()


def test_v2_full_lifecycle_scales_up_and_runs(ray_start_cluster):
    cluster = ray_start_cluster
    provider = FakeCloudProvider(cluster, boot_delay_s=0.3)
    scaler = AutoscalerV2(
        provider,
        [NodeType("gpuish", {"CPU": 2, "SPECIAL": 2}, max_workers=3)],
        idle_timeout_s=60, period_s=0.1).start()
    try:
        @ray_tpu_torch.remote(resources={"SPECIAL": 1})
        def special():
            return 42

        ref = special.remote()     # infeasible until a node launches
        assert ray_tpu_torch.get(ref, timeout=60) == 42
        inst = _wait(lambda: [i for i in scaler.instances.all()
                              if i.state == InstanceState.RUNNING])
        assert inst, scaler.instances.table()
        # lifecycle history: QUEUED->REQUESTED->ALLOCATED->RUNNING
        states = [t[2] for t in inst[0].transitions]
        assert states == ["REQUESTED", "ALLOCATED", "RUNNING"], states
        assert inst[0].node_id is not None
    finally:
        scaler.stop()


def test_v2_allocation_failure_requeues(ray_start_cluster):
    cluster = ray_start_cluster
    provider = FakeCloudProvider(cluster, fail_first_n=2)
    scaler = AutoscalerV2(
        provider,
        [NodeType("t", {"CPU": 1, "FLAKY": 1}, max_workers=2)],
        idle_timeout_s=60, period_s=0.1,
        max_launch_attempts=5).start()
    try:
        @ray_tpu_torch.remote(resources={"FLAKY": 1})
        def f():
            return "ok"

        assert ray_tpu_torch.get(f.remote(), timeout=60) == "ok"
        running = [i for i in scaler.instances.all()
                   if i.state == InstanceState.RUNNING]
        assert running and running[0].launch_attempts >= 3
    finally:
        scaler.stop()


def test_v2_allocation_failure_budget_exhausts(ray_start_cluster):
    cluster = ray_start_cluster
    provider = FakeCloudProvider(cluster, fail_first_n=100)
    scaler = AutoscalerV2(
        provider,
        [NodeType("t", {"CPU": 1, "NEVER": 1}, max_workers=1)],
        idle_timeout_s=60, period_s=0.05, max_launch_attempts=2).start()
    try:
        @ray_tpu_torch.remote(resources={"NEVER": 1})
        def f():
            return 1

        f.remote()   # stays infeasible
        failed = _wait(lambda: [
            i for i in scaler.instances.all()
            if i.state == InstanceState.ALLOCATION_FAILED])
        assert failed and failed[0].launch_attempts == 2
    finally:
        scaler.stop()


def test_v2_idle_termination(ray_start_cluster):
    cluster = ray_start_cluster
    provider = FakeCloudProvider(cluster)
    scaler = AutoscalerV2(
        provider, [NodeType("t", {"CPU": 1, "TMP": 1}, max_workers=1)],
        idle_timeout_s=0.5, period_s=0.1).start()
    try:
        @ray_tpu_torch.remote(resources={"TMP": 1})
        def f():
            return 1

        assert ray_tpu_torch.get(f.remote(), timeout=60) == 1
        gone = _wait(lambda: [i for i in scaler.instances.all()
                              if i.state == InstanceState.TERMINATED])
        assert gone, scaler.instances.table()
        # the node actually left the scheduler's view
        w = cluster._worker
        assert gone[0].node_id not in {
            nid for nid, _ in w.node_group.cluster_resources.nodes()}
    finally:
        scaler.stop()


# ---------------------------------------------------------------------------
# chaos-hardened provisioning (docs/autoscaler.md)


def test_v2_chaos_dropped_launch_converges(ray_start_cluster):
    """A launch lost cloud-side (chaos `drop` at the provider seam:
    the id never appears in describe) is only detectable by the
    REQUESTED deadline — the reconciler must requeue under backoff and
    converge to RUNNING within the retry budget."""
    from ray_tpu_torch._private import chaos
    cluster = ray_start_cluster
    provider = FakeCloudProvider(cluster, boot_delay_s=0.05)
    scaler = AutoscalerV2(
        provider, [NodeType("t", {"CPU": 1, "ELASTICA": 1},
                            max_workers=1)],
        idle_timeout_s=60, period_s=0.05, max_launch_attempts=5,
        upscale_delay_s=0.05, request_timeout_s=0.4).start()
    try:
        chaos.install("autoscaler.provider.launch:drop@1")

        @ray_tpu_torch.remote(resources={"ELASTICA": 1})
        def f():
            return "ok"

        assert ray_tpu_torch.get(f.remote(), timeout=60) == "ok"
        running = [i for i in scaler.instances.all()
                   if i.state == InstanceState.RUNNING]
        assert running, scaler.instances.table()
        # the dropped launch burned one attempt; convergence took >= 2
        assert running[0].launch_attempts >= 2
        assert scaler.num_launch_retries >= 1
    finally:
        chaos.clear()
        scaler.stop()


def test_v2_chaos_boot_then_die_converges(ray_start_cluster):
    """Boot-then-die (chaos `kill` at the boot point: the node joins
    and immediately dies, the allocation reports `gone`) re-launches
    from the retry budget and converges to RUNNING."""
    from ray_tpu_torch._private import chaos
    cluster = ray_start_cluster
    provider = FakeCloudProvider(cluster, boot_delay_s=0.05)
    scaler = AutoscalerV2(
        provider, [NodeType("t", {"CPU": 1, "ELASTICB": 1},
                            max_workers=1)],
        idle_timeout_s=60, period_s=0.05, max_launch_attempts=5,
        upscale_delay_s=0.05).start()
    try:
        chaos.install("autoscaler.provider.boot:kill@1")

        @ray_tpu_torch.remote(resources={"ELASTICB": 1}, max_retries=5)
        def f():
            return "ok"

        assert ray_tpu_torch.get(f.remote(), timeout=60) == "ok"
        running = [i for i in scaler.instances.all()
                   if i.state == InstanceState.RUNNING]
        assert running, scaler.instances.table()
        assert running[0].launch_attempts >= 2
        assert scaler.num_launch_retries >= 1
    finally:
        chaos.clear()
        scaler.stop()


# ---------------------------------------------------------------------------
# typed, gang-granular demand


def test_v2_parked_gpu_gang_unfences_after_scale_up():
    """Acceptance: a PACK'd 8-GPU placement group parks on a GPU-less
    head, the scaler reads the cohort as ONE gang-granular shape,
    launches one 8-GPU (logical) node, and every gang task completes —
    zero lost tasks."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)
    cluster = Cluster(head_num_cpus=4, num_gpus=0)
    scaler = None
    try:
        provider = FakeCloudProvider(cluster, boot_delay_s=0.05)
        scaler = AutoscalerV2(
            provider,
            [NodeType("gang", {"CPU": 4, "GPU": 8}, max_workers=1)],
            idle_timeout_s=60, period_s=0.05,
            upscale_delay_s=0.05).start()
        pg = placement_group([{"GPU": 1}] * 8, strategy="PACK")

        @ray_tpu_torch.remote(num_cpus=0, num_gpus=1)
        def rank_task(i):
            return i

        refs = [rank_task.options(
                    placement_group=pg,
                    placement_group_bundle_index=i).remote(i)
                for i in range(8)]
        assert ray_tpu_torch.get(refs, timeout=60) == list(range(8))
        # ONE 8-GPU node, not eight stray launches
        launched = [i for i in scaler.instances.all()
                    if i.state == InstanceState.RUNNING]
        assert len(launched) == 1, scaler.instances.table()
        assert launched[0].node_type == "gang"
        remove_placement_group(pg)
    finally:
        if scaler is not None:
            scaler.stop()
        cluster.shutdown()


def test_v2_unsatisfiable_demand_is_typed(ray_start_cluster):
    """A shape NO catalog type can ever fit becomes a typed
    UnsatisfiableDemandError — recorded, excluded from launch
    pressure, and never a launch loop."""
    from ray_tpu_torch.exceptions import UnsatisfiableDemandError
    cluster = ray_start_cluster
    provider = FakeCloudProvider(cluster)
    scaler = AutoscalerV2(
        provider, [NodeType("t", {"CPU": 2}, max_workers=2)],
        idle_timeout_s=60, period_s=0.05, upscale_delay_s=0.0,
        worker=cluster._worker)

    @ray_tpu_torch.remote(resources={"ANTIMATTER": 1})
    def f():
        return 1

    f.remote()      # parks: no node (and no catalog type) fits
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not scaler.unsatisfiable:
        scaler.reconcile_once()
        time.sleep(0.05)
    assert scaler.unsatisfiable, "shape never recorded unsatisfiable"
    err = next(iter(scaler.unsatisfiable.values()))
    assert isinstance(err, UnsatisfiableDemandError)
    assert err.demand.get("ANTIMATTER") == 1
    assert err.node_types == ["t"]
    # no instance was ever minted for it
    assert scaler.instances.all() == []


def test_v2_unplaceable_report_carries_feasible_types(
        ray_start_cluster):
    """Satellite: with a registered catalog, unplaceable_report
    entries state WHICH node types could fit each parked class (the
    CapacityInfeasibleError plumbing itself is untouched)."""
    cluster = ray_start_cluster
    w = cluster._worker
    provider = FakeCloudProvider(cluster)
    scaler = AutoscalerV2(
        provider,
        [NodeType("small", {"CPU": 2}, max_workers=1),
         NodeType("big", {"CPU": 2, "WIDE": 4}, max_workers=1)],
        idle_timeout_s=60, period_s=0.05,
        # upscale gate held shut: this test reads the REPORT, the
        # demand must stay parked
        upscale_delay_s=3600, worker=w)
    assert scaler is not None

    @ray_tpu_torch.remote(resources={"WIDE": 2})
    def f():
        return 1

    f.remote()
    entry = _wait(lambda: [e for e in w.node_group.unplaceable_report()
                           if "WIDE" in e["demand"]])
    assert entry, w.node_group.unplaceable_report()
    assert entry[0]["feasible_types"] == ["big"]


# ---------------------------------------------------------------------------
# drain-before-terminate scale-down


def test_v2_scale_down_drains_checkpointed_actor(ray_start_cluster):
    """Acceptance: scale-down of a node hosting a checkpointable
    actor cordons it, saves through the checkpoint plane, migrates
    the actor (restore included), and only then terminates — zero
    lost actor state, and the voluntary move consumes no restart
    budget."""
    cluster = ray_start_cluster
    provider = FakeCloudProvider(cluster, boot_delay_s=0.05)
    scaler = AutoscalerV2(
        provider,
        [NodeType("pool", {"CPU": 2, "POOL": 2}, max_workers=2)],
        idle_timeout_s=0.6, period_s=0.05, upscale_delay_s=0.05,
        downscale_delay_s=0.3, drain_timeout_s=15.0).start()
    try:
        @ray_tpu_torch.remote(num_cpus=0, resources={"POOL": 1},
                        max_restarts=1, max_task_retries=2,
                        checkpoint_interval=1)
        class Counter:
            def __init__(self):
                self.n = 0

            def bump(self):
                self.n += 1
                return self.n

            def __ray_save__(self):
                return {"n": self.n}

            def __ray_restore__(self, state):
                self.n = state["n"]

        a = Counter.remote()      # parks until the scaler supplies POOL
        for expect in (1, 2, 3):
            assert ray_tpu_torch.get(a.bump.remote(), timeout=60) == expect
        # go idle: the scaler drains the pool node (cordon ->
        # checkpoint -> migrate -> terminate); the resubmitted actor
        # parks again and a FRESH instance hosts the restore
        drained = _wait(lambda: scaler.num_drains >= 1, timeout=60)
        assert drained, scaler.report()
        # state survived the migration: the counter resumes at 4
        assert ray_tpu_torch.get(a.bump.remote(), timeout=60) == 4
        # the drained instance terminated and a fresh one re-hosted
        # the actor (the migration round-trip, not an in-place no-op)
        terminated = [i for i in scaler.instances.all()
                      if i.state == InstanceState.TERMINATED]
        assert terminated, scaler.instances.table()
        assert len(scaler.instances.all()) >= 2, \
            scaler.instances.table()
    finally:
        scaler.stop()


def test_v2_chaos_kill_mid_drain_loses_no_state(ray_start_cluster):
    """Acceptance: a chaos kill landing DURING the drain (the save-now
    snapshot dies mid-write) surfaces through the existing
    restart/restore taxonomy — the drain refuses (node kept), the
    actor restarts from its last committed generation, and no state
    is lost."""
    from ray_tpu_torch._private import chaos
    cluster = ray_start_cluster
    provider = FakeCloudProvider(cluster, boot_delay_s=0.05)
    scaler = AutoscalerV2(
        provider,
        [NodeType("pool", {"CPU": 2, "POOLK": 2}, max_workers=2)],
        idle_timeout_s=0.6, period_s=0.05, upscale_delay_s=0.05,
        downscale_delay_s=0.3, drain_timeout_s=4.0).start()
    try:
        @ray_tpu_torch.remote(num_cpus=0, resources={"POOLK": 1},
                        max_restarts=2, max_task_retries=2,
                        checkpoint_interval=1)
        class Counter:
            def __init__(self):
                self.n = 0

            def bump(self):
                self.n += 1
                return self.n

            def __ray_save__(self):
                return {"n": self.n}

            def __ray_restore__(self, state):
                self.n = state["n"]

        a = Counter.remote()
        for expect in (1, 2):
            assert ray_tpu_torch.get(a.bump.remote(), timeout=60) == expect
        # the NEXT save (the drain's save-now) dies mid-write: a torn
        # generation that must never commit
        chaos.install("actor.checkpoint.save:kill@1")
        # wait out at least one drain attempt window
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            if any(i.state == InstanceState.TERMINATING
                   for i in scaler.instances.all()) \
                    or scaler.num_drains >= 1:
                break
            time.sleep(0.05)
        # whether the drain refused (kept node) or a later attempt
        # succeeded from the last committed generation, the counter's
        # history is intact: no double-applied and no lost bumps
        assert ray_tpu_torch.get(a.bump.remote(), timeout=60) == 3
        assert ray_tpu_torch.get(a.bump.remote(), timeout=60) == 4
    finally:
        chaos.clear()
        scaler.stop()


# ---------------------------------------------------------------------------
# composition: serve autoscaler x cluster autoscaler


def test_v2_anti_oscillation_composition(ray_start_cluster):
    """Satellite: under a sustained step load, the serve autoscaler
    (replica counts) and the cluster autoscaler (instance counts)
    compose without oscillation — both series are monotone
    non-decreasing for the whole load window (direction-stable delays
    on both loops), polled against a deadline."""
    from ray_tpu_torch import serve
    cluster = ray_start_cluster
    provider = FakeCloudProvider(cluster, boot_delay_s=0.05)
    scaler = AutoscalerV2(
        provider,
        [NodeType("pool", {"CPU": 2, "STEP": 2}, max_workers=3)],
        idle_timeout_s=30.0, period_s=0.05, upscale_delay_s=0.2,
        downscale_delay_s=30.0).start()
    try:
        @serve.deployment(autoscaling_config={
            "min_replicas": 1, "max_replicas": 3,
            "target_ongoing_requests": 1.0,
            "upscale_delay_s": 0.2, "downscale_delay_s": 30.0})
        class Slow:
            def __call__(self, x):
                time.sleep(0.3)
                return x

        handle = serve.run(Slow.bind())

        @ray_tpu_torch.remote(num_cpus=0, resources={"STEP": 1},
                        max_retries=5)
        def step_task(i):
            time.sleep(0.2)
            return i

        # step load: serve flood + a standing stream of STEP tasks
        serve_refs = [handle.remote(i) for i in range(10)]
        task_refs = [step_task.remote(i) for i in range(8)]

        # Sample until both loops have visibly scaled, then keep
        # watching for one more second to catch any flap. The cap is
        # far from the event (the reference's is 8 s), so the case
        # waits for the scaling it asserts on even under load.
        replica_series = []
        instance_series = []
        hard_deadline = time.monotonic() + 60.0
        scaled_at = None
        while time.monotonic() < hard_deadline:
            replica_series.append(
                serve.status()["Slow"]["live_replicas"])
            instance_series.append(len([
                i for i in scaler.instances.all()
                if i.state == InstanceState.RUNNING]))
            now = time.monotonic()
            if (scaled_at is None and max(instance_series) >= 1
                    and max(replica_series) >= 2):
                scaled_at = now
            if scaled_at is not None and now - scaled_at >= 1.0:
                break
            time.sleep(0.1)

        ray_tpu_torch.get(serve_refs, timeout=120)
        ray_tpu_torch.get(task_refs, timeout=120)

        # both loops actually scaled...
        assert max(instance_series) >= 1, instance_series
        assert max(replica_series) >= 2, replica_series
        # ...and neither flapped: monotone non-decreasing under load
        for name, series in (("replicas", replica_series),
                             ("instances", instance_series)):
            for a, b in zip(series, series[1:]):
                assert b >= a, f"{name} oscillated: {series}"
    finally:
        try:
            from ray_tpu_torch import serve
            serve.shutdown()
        except Exception:
            pass
        scaler.stop()


# ---------------------------------------------------------------------------
# the port against the JAX package


class _Res:
    def __init__(self, total):
        self.total = total
        self.alive = True


class _Nodes:
    def __init__(self, totals):
        self._totals = totals

    def nodes(self):
        return [(i, _Res(dict(t))) for i, t in enumerate(self._totals)]


class _Worker:
    """What ``_subtract_capacity`` reads of a runtime: the nodes'
    totals."""

    def __init__(self, totals):
        self.node_group = type("NG", (), {})()
        self.node_group.cluster_resources = _Nodes(totals)


def _scaler(v2, catalog, totals, queued):
    """A package's AutoscalerV2 over stub cluster state, without a
    runtime: ``catalog`` [(name, resources)], node ``totals``, and the
    names of node types already QUEUED."""
    s = object.__new__(v2.AutoscalerV2)
    pkg = v2.__name__.split(".")[0]
    NodeTypeCls = __import__(f"{pkg}.autoscaler",
                             fromlist=["NodeType"]).NodeType
    s.node_types = {n: NodeTypeCls(n, dict(r)) for n, r in catalog}
    s.instances = v2.InstanceManager()
    for name in queued:
        s.instances.add(name)
    s._worker = _Worker(totals)
    return s


def _rename(d, accel):
    return {(accel if k == "ACC" else k): v for k, v in d.items()}


def test_demand_matching_matches_the_jax_package():
    import ray_tpu.autoscaler.v2 as jax_v2
    import ray_tpu_torch.autoscaler.v2 as port_v2

    rs = np.random.RandomState(0)
    keys = ("CPU", "ACC", "MEM")

    def shape(low=0):
        out = {}
        for k in keys:
            if rs.rand() < 0.6:
                out[k] = float(rs.choice([0.5, 1, 2, 4, 8]))
        return out or {"CPU": 1.0}

    checked = 0
    for _ in range(50):
        catalog = [(f"t{j}", shape()) for j in range(rs.randint(1, 5))]
        totals = [shape() for _ in range(rs.randint(0, 4))]
        queued = [catalog[rs.randint(len(catalog))][0]
                  for _ in range(rs.randint(0, 3))]
        demand = [shape() for _ in range(rs.randint(1, 12))]
        outs = []
        for v2, accel in ((jax_v2, "TPU"), (port_v2, "GPU")):
            s = _scaler(v2, [(n, _rename(r, accel)) for n, r in catalog],
                        [_rename(t, accel) for t in totals], queued)
            shapes = [_rename(d, accel) for d in demand]
            picks = [getattr(s._pick_node_type(d), "name", None)
                     for d in shapes]
            unmet = s._subtract_capacity(shapes)
            back = [{("ACC" if k == accel else k): v for k, v in u.items()}
                    for u in unmet]
            outs.append((picks, back))
        assert outs[0] == outs[1]
        checked += len(demand)
    assert checked > 50


def test_remote_gpu_node_type_is_refused(ray_start_cluster):
    cluster = ray_start_cluster
    gpu_type = NodeType("gpu", {"CPU": 1, "GPU": 1}, max_workers=1)
    with pytest.raises(ValueError, match="see no card") as v1_err:
        Autoscaler(ClusterNodeProvider(cluster, remote=True), [gpu_type])
    with pytest.raises(ValueError, match="see no card") as v2_err:
        AutoscalerV2(FakeCloudProvider(cluster, remote=True), [gpu_type])
    with pytest.raises(ValueError, match="see no card") as direct:
        cluster.add_node(num_cpus=1, num_gpus=1, remote=True)
    assert str(v1_err.value) == str(v2_err.value) == str(direct.value)
    # a logical GPU node type and a remote CPU one are accepted
    AutoscalerV2(FakeCloudProvider(cluster), [gpu_type]).stop()
    AutoscalerV2(FakeCloudProvider(cluster, remote=True),
                 [NodeType("cpu", {"CPU": 1})]).stop()


def test_v2_gauges_follow_a_gpu_node(ray_start_cluster):
    """A pending ``num_gpus=1`` actor makes the scaler launch one logical
    ``{"CPU": 1, "GPU": 1}`` node; the actor answers on a driver thread;
    once it is killed and the node is idle past ``idle_timeout_s`` the
    node is terminated. The ``ray_tpu_autoscaler_instances`` gauge shows
    RUNNING then TERMINATED."""
    import os
    from ray_tpu_torch.util import metrics
    cluster = ray_start_cluster
    scaler = AutoscalerV2(
        FakeCloudProvider(cluster, boot_delay_s=0.05),
        [NodeType("gpu", {"CPU": 1, "GPU": 1}, max_workers=1)],
        idle_timeout_s=0.5, period_s=0.05, upscale_delay_s=0.05,
        downscale_delay_s=0.2).start()

    def gauge(state):
        for line in metrics.prometheus_text().splitlines():
            if line.startswith("ray_tpu_autoscaler_instances{") \
                    and f'state="{state}"' in line:
                return float(line.rsplit(" ", 1)[1])
        return 0.0

    try:
        @ray_tpu_torch.remote(num_gpus=1)
        class Replica:
            def pid(self):
                return os.getpid()

        r = Replica.remote()
        assert ray_tpu_torch.get(r.pid.remote(), timeout=60) == os.getpid()
        assert _wait(lambda: gauge("RUNNING") == 1.0), \
            metrics.prometheus_text()
        ray_tpu_torch.kill(r)
        assert _wait(lambda: gauge("TERMINATED") == 1.0), \
            scaler.instances.table()
        assert gauge("RUNNING") == 0.0
        gone = [i for i in scaler.instances.all()
                if i.state == InstanceState.TERMINATED]
        assert len(gone) == 1 and len(scaler.instances.all()) == 1
    finally:
        scaler.stop()
