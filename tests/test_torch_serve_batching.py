"""The port's Serve plane at production traffic: the cases of the JAX
package's ``tests/test_serve_batching.py`` (dynamic batching,
queue-aware routing, backpressure shed, EWMA autoscaling, zero-copy
argument routing, shutdown ordering, multiplexing, the Serve gauges) run
against ``ray_tpu_torch.serve`` on ``init(num_cpus=4, num_gpus=8,
max_process_workers=2)``.

One case differs from the reference:
``test_autoscaler_scales_up_under_queue_and_drains_down`` keeps its
load up until the scale-up is seen (or a deadline passes) instead of
sending one fixed burst of 48 requests, which one async replica can
absorb inside a single autoscale interval.
"""

import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch._private import serve_stats
from ray_tpu_torch.exceptions import BackpressureError


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def ray_start_regular():
    """A small single-host runtime (2 process workers, 8 GPUs of
    resource; no card is needed for work that demands none)."""
    w = ray_tpu_torch.init(num_cpus=4, num_gpus=8, max_process_workers=2)
    yield w
    ray_tpu_torch.shutdown()


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>[-+0-9.eE]+)\s*$")


def gauge(name, labels=None):
    """Value of the first sample of ``name`` in the port's Prometheus
    text whose labels include ``labels`` (None if the series is
    absent)."""
    from ray_tpu_torch.util import metrics
    want = labels or {}
    for line in metrics.prometheus_text().splitlines():
        m = _SAMPLE_RE.match(line)
        if m is None or m.group("name") != name:
            continue
        got = {}
        for part in (m.group("labels") or "").split(","):
            k, _, v = part.strip().partition("=")
            if k:
                got[k.strip()] = v.strip().strip('"')
        if all(got.get(k) == v for k, v in want.items()):
            return float(m.group("value"))
    return None


def assert_serve_settled(*deployments, timeout=20.0, extra_probes=()):
    """Deadline-poll until every named deployment is quiet — no queued
    or ongoing requests in ``serve.status()`` and the queue-depth gauge
    at zero — plus any ``extra_probes``, all in the same round."""
    def quiet(name):
        st = serve.status().get(name)
        return st is None or (st["queued_requests"] == 0
                              and st["ongoing_requests"] == 0)

    def depth_zero(name):
        v = gauge("ray_tpu_serve_queue_depth", {"deployment": name})
        return v is None or v == 0

    probes = []
    for name in deployments:
        probes.append((f"serve.status[{name}] queued/ongoing == 0",
                       lambda name=name: quiet(name)))
        probes.append((f'ray_tpu_serve_queue_depth{{deployment="{name}"}}'
                       " == 0", lambda name=name: depth_zero(name)))
    probes.extend(extra_probes)
    deadline = time.monotonic() + timeout
    failing = [d for d, _ in probes]
    while time.monotonic() < deadline:
        failing = []
        for desc, pred in probes:
            try:
                if not pred():
                    failing.append(desc)
            except Exception as e:  # noqa: BLE001 - probe itself unhappy
                failing.append(f"{desc} (probe error: {e!r})")
        if not failing:
            return
        time.sleep(0.1)
    raise AssertionError("still failing: " + "; ".join(failing))


@pytest.fixture
def serve_instance(ray_start_regular):
    serve_stats.reset()
    yield serve
    serve.shutdown()


def _pid_of_replicas(name):
    """pid per live replica handle, via a direct per-handle call (the
    router would load-balance; tests need the mapping)."""
    controller = serve._controller
    out = {}
    for handle in list(controller._deployments[name].replicas):
        pid = ray_tpu_torch.get(
            handle.handle_request.remote("pid", (), {}, None), timeout=30)
        out[pid] = handle
    return out


# ---------------------------------------------------------------------------
# dynamic batching
# ---------------------------------------------------------------------------

def test_batch_vectorizes_and_preserves_order(serve_instance):
    """A burst through the batched path arrives as vectorized calls
    (realized batch > 1) and every request gets ITS result."""

    @serve.deployment(num_replicas=1)
    class Vec:
        def __init__(self):
            self.peak = 0

        @serve.batch(max_batch_size=16, batch_wait_timeout_ms=20)
        async def __call__(self, items):
            self.peak = max(self.peak, len(items))
            return [x * 3 for x in items]

        def peak_seen(self):
            return self.peak

        def pid(self):
            return os.getpid()

    handle = serve.run(Vec.bind())
    refs = [handle.remote(i) for i in range(48)]
    assert ray_tpu_torch.get(refs, timeout=60) == [i * 3 for i in range(48)]
    peak = ray_tpu_torch.get(handle.peak_seen.remote(), timeout=30)
    assert peak > 1, f"never batched (peak={peak})"
    assert serve_stats.batch_avg() > 1.0


def test_batch_idle_bypass_serial_latency(serve_instance):
    """A request on an idle deployment dispatches immediately — the
    gather window only arms while dispatches are outstanding."""

    @serve.deployment(num_replicas=1)
    class Echo:
        # a wait window far above the assertion bound: if the idle
        # bypass regressed, serial calls would pay it and fail
        @serve.batch(max_batch_size=64, batch_wait_timeout_ms=500)
        async def __call__(self, items):
            return items

    handle = serve.run(Echo.bind())
    ray_tpu_torch.get(handle.remote(0), timeout=30)     # warm
    t0 = time.perf_counter()
    for i in range(5):
        assert ray_tpu_torch.get(handle.remote(i), timeout=30) == i
    per_call = (time.perf_counter() - t0) / 5
    assert per_call < 0.4, (
        f"serial batched call paid the gather window: {per_call:.3f}s")


def test_batch_function_deployment(serve_instance):
    @serve.deployment
    @serve.batch(max_batch_size=8, batch_wait_timeout_ms=10)
    async def doubler(items):
        return [x * 2 for x in items]

    handle = serve.run(doubler.bind())
    assert ray_tpu_torch.get([handle.remote(i) for i in range(12)],
                       timeout=60) == [i * 2 for i in range(12)]


def test_batch_per_item_user_error_isolated(serve_instance):
    """One poisoned request fails TYPED; its batch-mates succeed (user
    errors ride inside the envelope, never fail the dispatch)."""

    @serve.deployment(num_replicas=1)
    class Picky:
        @serve.batch(max_batch_size=16, batch_wait_timeout_ms=20)
        async def __call__(self, items):
            out = []
            for x in items:
                if x == 13:
                    raise ValueError("unlucky")
                out.append(x + 1)
            return out

    handle = serve.run(Picky.bind())
    # the poisoned item fails its WHOLE vectorized call (user code
    # raised before returning per-item results) -> every item of that
    # batch gets the typed user error; items of other batches succeed
    ok = ray_tpu_torch.get([handle.remote(i) for i in range(5)], timeout=60)
    assert ok == [1, 2, 3, 4, 5]
    with pytest.raises(Exception) as ei:
        ray_tpu_torch.get(handle.remote(13), timeout=60)
    assert "unlucky" in str(ei.value)
    # the deployment keeps serving afterwards
    assert ray_tpu_torch.get(handle.remote(1), timeout=60) == 2


def test_replica_gather_queue_batches_side_traffic(serve_instance):
    """The replica-side gather queue: single-request calls arriving
    individually (a pickled ReplicaSet copy — no driver flusher)
    still coalesce into vectorized calls at the replica."""

    @serve.deployment(num_replicas=1)
    class Vec:
        def __init__(self):
            self.peak = 0

        @serve.batch(max_batch_size=8, batch_wait_timeout_ms=50)
        async def __call__(self, items):
            self.peak = max(self.peak, len(items))
            return list(items)

        def peak_seen(self):
            return self.peak

    serve.run(Vec.bind())
    import cloudpickle
    rs_copy = cloudpickle.loads(
        cloudpickle.dumps(serve._controller.get_replica_set("Vec")))
    assert rs_copy._driver_side is False
    refs = [rs_copy.assign("__call__", (i,), {}) for i in range(12)]
    assert sorted(ray_tpu_torch.get(refs, timeout=60)) == list(range(12))
    handle = serve.get_deployment_handle("Vec")
    peak = ray_tpu_torch.get(handle.peak_seen.remote(), timeout=30)
    assert peak > 1, "replica-side gather queue never batched"


# ---------------------------------------------------------------------------
# overload: shed + chaos exactly-once (satellite)
# ---------------------------------------------------------------------------

def test_shed_surfaces_backpressure_error(serve_instance):
    """Beyond max_queued_requests the handle sheds with the PR-3
    retryable BackpressureError; the shed gauge moves; queue gauges
    return to baseline after the load stops."""

    @serve.deployment(num_replicas=1, max_queued_requests=6)
    class Slow:
        @serve.batch(max_batch_size=2, batch_wait_timeout_ms=1)
        async def __call__(self, items):
            import asyncio
            await asyncio.sleep(0.3)
            return items

    handle = serve.run(Slow.bind())
    accepted, sheds = [], []
    for i in range(40):
        try:
            accepted.append(handle.remote(i))
        except BackpressureError as e:
            sheds.append(e)
    assert sheds, "queue bound never shed"
    assert all(e.retryable for e in sheds)
    assert all(e.backoff_s >= 0 for e in sheds)
    assert serve_stats.snapshot()["shed"] == len(sheds)
    # every ACCEPTED request resolves (no lost responses under shed)
    results = ray_tpu_torch.get(accepted, timeout=120)
    assert len(results) == len(accepted)
    # gauges: serve sheds fold into ray_tpu_tasks{state=shed}; the
    # deployment then settles (queued/ongoing AND queue-depth gauge)
    shed = gauge("ray_tpu_tasks", {"state": "shed"})
    assert shed is not None and shed >= len(sheds)
    assert_serve_settled("Slow", timeout=15)


def test_http_shed_returns_503_with_retry_after(serve_instance):
    @serve.deployment(num_replicas=1, max_queued_requests=2)
    class Slow:
        @serve.batch(max_batch_size=1, batch_wait_timeout_ms=1)
        async def __call__(self, items):
            import asyncio
            await asyncio.sleep(0.4)
            return items

    serve.run(Slow.bind())
    host, port = serve.http_address()
    url = f"http://{host}:{port}/Slow"
    codes, retry_after = [], []
    lock = threading.Lock()

    def fire():
        req = urllib.request.Request(
            url, data=json.dumps(1).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                with lock:
                    codes.append(resp.status)
        except urllib.error.HTTPError as e:
            with lock:
                codes.append(e.code)
                if e.code == 503:
                    retry_after.append(e.headers.get("Retry-After"))

    threads = [threading.Thread(target=fire) for _ in range(10)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90)
    assert 503 in codes, codes
    assert 200 in codes, codes          # admitted requests still served
    assert retry_after and all(ra is not None and int(ra) >= 1
                               for ra in retry_after)


def test_batched_chaos_kill_exactly_once(serve_instance):
    """ACCEPTANCE: two-replica batched deployment; one replica is
    killed while provably mid-batch. Every request resolves EXACTLY
    once — the dead replica's batch retries on the survivor, nothing
    is lost, nothing double-resolves — and the whole-batch retry is
    observable."""
    import tempfile
    marker_dir = tempfile.mkdtemp(prefix="rtpu_serve_chaos_")

    @serve.deployment(num_replicas=2)
    class Slow:
        def __init__(self, marker_dir):
            self.marker_dir = marker_dir

        @serve.batch(max_batch_size=8, batch_wait_timeout_ms=5)
        async def __call__(self, items):
            import asyncio
            with open(os.path.join(self.marker_dir,
                                   f"{os.getpid()}.start"), "w") as f:
                f.write(str(len(items)))
            await asyncio.sleep(1.5)
            return [x + 100 for x in items]

        def pid(self):
            return os.getpid()

    handle = serve.run(Slow.bind(marker_dir))
    by_pid = _pid_of_replicas("Slow")
    assert len(by_pid) == 2
    serve_stats.reset()
    refs = [handle.remote(i) for i in range(32)]
    # wait until SOME replica is provably inside a batch (its start
    # marker exists), then kill it while the batch still sleeps
    victim_pid = None
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and victim_pid is None:
        for fn in os.listdir(marker_dir):
            pid = int(fn.split(".")[0])
            if pid in by_pid:
                victim_pid = pid
                break
        time.sleep(0.02)
    assert victim_pid is not None, "no batch ever started"
    ray_tpu_torch.kill(by_pid[victim_pid])
    # EVERY request resolves exactly once, with its own result
    results = ray_tpu_torch.get(refs, timeout=120)
    assert results == [i + 100 for i in range(32)]
    assert serve_stats.snapshot()["batch_retries"] >= 1, (
        "victim died mid-batch but no whole-batch retry was recorded")
    # the deployment recovers to 2 replicas and keeps serving
    assert ray_tpu_torch.get(handle.remote(1), timeout=60) == 101


# ---------------------------------------------------------------------------
# autoscaling (EWMA on queue depth + ongoing)
# ---------------------------------------------------------------------------

def test_autoscaler_scales_up_under_queue_and_drains_down(serve_instance):
    """ACCEPTANCE: the autoscaler observably scales up under batched
    queue pressure and drains back down to min after."""

    @serve.deployment(autoscaling_config={
        "min_replicas": 1, "max_replicas": 3,
        "target_ongoing_requests": 2.0,
        "upscale_delay_s": 0.2, "downscale_delay_s": 0.6})
    class Slow:
        @serve.batch(max_batch_size=4, batch_wait_timeout_ms=5)
        async def __call__(self, items):
            import asyncio
            await asyncio.sleep(0.4)
            return items

    handle = serve.run(Slow.bind())
    assert serve.status()["Slow"]["live_replicas"] == 1
    # Sustained queue pressure: 8 more requests every 0.1 s until the
    # scale-up shows (one burst of 48 completes on the one async
    # replica in ~0.45 s, between two autoscale evaluations 0.5 s
    # apart, so the autoscaler may never see it).
    refs = []
    deadline = time.monotonic() + 60
    peak = 1
    while time.monotonic() < deadline:
        refs += [handle.remote(len(refs) + i) for i in range(8)]
        peak = max(peak, serve.status()["Slow"]["live_replicas"])
        if peak >= 2:
            break
        time.sleep(0.1)
    assert peak >= 2, f"never scaled up: {serve.status()}"
    assert ray_tpu_torch.get(refs, timeout=120) == list(range(len(refs)))
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if serve.status()["Slow"]["live_replicas"] == 1:
            break
        time.sleep(0.2)
    assert serve.status()["Slow"]["live_replicas"] == 1, (
        f"never drained down: {serve.status()}")


# ---------------------------------------------------------------------------
# zero-copy argument routing
# ---------------------------------------------------------------------------

def test_zero_copy_large_payload_direct_and_batched(ray_start_regular):
    """Large ndarray/bytes args are promoted to object-store refs at
    the handle (one put; hops move a fixed-size id) and the replica
    sees the VALUE — both the direct and the batched path."""
    import ray_tpu_torch as rt
    rt.shutdown()
    rt.init(num_cpus=4, num_gpus=0, max_process_workers=2,
            _system_config={"serve_zero_copy_threshold_bytes": 4096})
    try:
        from ray_tpu_torch import serve as s

        @s.deployment(num_replicas=1)
        class Sum:
            def __call__(self, arr):
                return float(np.asarray(arr).sum())

            @s.batch(max_batch_size=4, batch_wait_timeout_ms=10)
            async def bsum(self, arrs):
                return [float(np.asarray(a).sum()) for a in arrs]

        handle = s.run(Sum.bind())
        big = np.ones(64 * 1024, dtype=np.float32)       # 256 KiB
        assert ray_tpu_torch.get(handle.remote(big), timeout=60) == big.size
        outs = ray_tpu_torch.get([handle.bsum.remote(big) for _ in range(6)],
                           timeout=60)
        assert outs == [float(big.size)] * 6
        # below threshold: inline, still correct
        small = np.ones(16, dtype=np.float32)
        assert ray_tpu_torch.get(handle.remote(small), timeout=60) == 16.0
        s.shutdown()
    finally:
        rt.shutdown()


# ---------------------------------------------------------------------------
# handle method cache (satellite)
# ---------------------------------------------------------------------------

def test_handle_method_proxy_cached(serve_instance):
    @serve.deployment
    class M:
        def foo(self):
            return "foo"

    handle = serve.run(M.bind())
    p1 = handle.foo
    p2 = handle.foo
    assert p1 is p2, "method proxy rebuilt per attribute access"
    assert handle.method("foo") is p1
    assert ray_tpu_torch.get(p1.remote(), timeout=30) == "foo"
    # options() returns a NEW handle with its own cache (different
    # model id must not share routing state through a stale proxy)
    h2 = handle.options(multiplexed_model_id=None)
    assert h2.foo is not p1


# ---------------------------------------------------------------------------
# shutdown ordering (satellite)
# ---------------------------------------------------------------------------

def test_shutdown_drains_inflight_http(ray_start_regular):
    """serve.shutdown while an HTTP request is mid-flight through the
    worker-hosted proxy: the request completes (drain-before-kill),
    and shutdown converges without raising."""
    from ray_tpu_torch import serve as s

    @s.deployment(num_replicas=1)
    class Slow:
        def __call__(self, _payload=None):
            time.sleep(1.0)
            return {"ok": True}

    s.start(http=True, proxy_location="worker")
    s.run(Slow.bind())
    host, port = s.http_address()
    url = f"http://{host}:{port}/Slow"
    results = {}

    def fire():
        req = urllib.request.Request(
            url, data=b"{}",
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                results["status"] = resp.status
                results["body"] = json.loads(resp.read())
        except Exception as e:  # noqa: BLE001 - asserted below
            results["error"] = repr(e)

    # make sure the route is live before the timed window
    fire()
    assert results.get("status") == 200, results
    results.clear()
    t = threading.Thread(target=fire)
    t.start()
    time.sleep(0.35)           # request is now sleeping in the replica
    s.shutdown()               # drain-ordered teardown
    t.join(timeout=60)
    assert results.get("status") == 200, (
        f"in-flight request raced shutdown: {results}")


def test_shutdown_idempotent_and_clean(serve_instance):
    @serve.deployment
    def f(x):
        return x

    serve.run(f.bind())
    serve.shutdown()
    serve.shutdown()           # second call is a no-op, not an error
    assert serve._controller is None


# ---------------------------------------------------------------------------
# @serve.multiplexed satellite coverage
# ---------------------------------------------------------------------------

def test_multiplexed_evict_before_load_cap(ray_start_regular):
    """Cap models RESIDENT at once: eviction happens BEFORE the load,
    so the cache never transiently holds cap+1 entries."""
    from ray_tpu_torch import serve as s

    @s.deployment(num_replicas=1)
    class Mux:
        def __init__(self):
            self.max_resident_at_load = 0

        @s.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id):
            cache = getattr(self, "_rtpu_mux_cache_get_model", None)
            resident = len(cache) if cache is not None else 0
            self.max_resident_at_load = max(
                self.max_resident_at_load, resident)
            return model_id

        def __call__(self, _x):
            self.get_model(s.get_multiplexed_model_id())
            return self.max_resident_at_load

    handle = s.run(Mux.bind(), name="mux-cap")
    try:
        worst = 0
        for mid in ("a", "b", "c", "d", "a", "c"):
            worst = ray_tpu_torch.get(handle.options(
                multiplexed_model_id=mid).remote(0), timeout=60)
        # at load time at most cap-1 entries are resident (the slot
        # for the incoming model is already free)
        assert worst <= 1, (
            f"{worst + 1} models resident during a load (cap 2)")
    finally:
        s.delete("mux-cap")


def test_multiplexed_per_function_cache_isolation(ray_start_regular):
    """Two multiplexed loaders on one class keep separate caches and
    separate caps — loading through one never evicts the other's."""
    from ray_tpu_torch import serve as s

    @s.deployment(num_replicas=1)
    class Mux:
        def __init__(self):
            self.loads_a = []
            self.loads_b = []

        @s.multiplexed(max_num_models_per_replica=1)
        def load_a(self, model_id):
            self.loads_a.append(model_id)
            return model_id

        @s.multiplexed(max_num_models_per_replica=1)
        def load_b(self, model_id):
            self.loads_b.append(model_id)
            return model_id

        def __call__(self, which):
            mid = s.get_multiplexed_model_id()
            (self.load_a if which == "a" else self.load_b)(mid)
            return {"a": list(self.loads_a), "b": list(self.loads_b)}

    handle = s.run(Mux.bind(), name="mux-iso")
    try:
        h = handle.options(multiplexed_model_id="m1")
        ray_tpu_torch.get(h.remote("a"), timeout=60)
        ray_tpu_torch.get(h.remote("b"), timeout=60)
        out = ray_tpu_torch.get(h.remote("a"), timeout=60)
        # cap 1 each: m1 stayed cached in A even though B also loaded
        # m1 (separate caches -> A never reloaded)
        assert out["a"] == ["m1"], out
        assert out["b"] == ["m1"], out
    finally:
        s.delete("mux-iso")


def test_batched_multiplexed_models_never_mix(serve_instance):
    """Replica-side gather queues key by model id: concurrent
    single-call traffic for two models (a pickled copy — no driver
    flusher) batches model-homogeneously, and every request's result
    reflects ITS model, not the first submitter's ContextVar."""

    @serve.deployment(num_replicas=1)
    class Mux:
        @serve.batch(max_batch_size=8, batch_wait_timeout_ms=30)
        async def __call__(self, items):
            mid = serve.get_multiplexed_model_id()
            return [(mid, x) for x in items]

    serve.run(Mux.bind())
    import cloudpickle
    rs_copy = cloudpickle.loads(
        cloudpickle.dumps(serve._controller.get_replica_set("Mux")))
    refs = []
    for i in range(10):
        mid = "m-a" if i % 2 == 0 else "m-b"
        refs.append(rs_copy.assign("__call__", (i,), {}, model_id=mid))
    out = ray_tpu_torch.get(refs, timeout=60)
    for i, (mid, x) in enumerate(out):
        assert x == i
        assert mid == ("m-a" if i % 2 == 0 else "m-b"), (i, mid)


def test_multiplexed_sticky_survives_replica_restart(serve_instance):
    """Kill the replica a model is pinned to: requests for that model
    re-pin to a live replica (service continues) and stay sticky."""

    @serve.deployment(num_replicas=2)
    class Mux:
        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id):
            return model_id

        def __call__(self, _x):
            self.get_model(serve.get_multiplexed_model_id())
            return os.getpid()

        def pid(self):
            return os.getpid()

    handle = serve.run(Mux.bind())
    by_pid = _pid_of_replicas("Mux")
    h = handle.options(multiplexed_model_id="m-a")
    pids = {ray_tpu_torch.get(h.remote(i), timeout=60) for i in range(4)}
    assert len(pids) == 1, f"sticky routing broken pre-kill: {pids}"
    pinned_pid = pids.pop()
    ray_tpu_torch.kill(by_pid[pinned_pid])
    # recovery: requests for the model succeed and re-pin (single
    # replica process serves them all again)
    deadline = time.monotonic() + 60
    post = None
    while time.monotonic() < deadline:
        try:
            post = {ray_tpu_torch.get(h.remote(i), timeout=30)
                    for i in range(4)}
            break
        except Exception:  # noqa: BLE001 - replica mid-replacement
            time.sleep(0.2)
    assert post is not None, "model requests never recovered"
    assert len(post) == 1, f"re-pin not sticky: {post}"
    assert post.pop() != pinned_pid


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------

def test_serve_gauges_move_under_batched_load(serve_instance):
    @serve.deployment(num_replicas=2)
    class Echo:
        @serve.batch(max_batch_size=16, batch_wait_timeout_ms=5)
        async def __call__(self, items):
            return items

    handle = serve.run(Echo.bind())
    refs = [handle.remote(i) for i in range(64)]
    assert ray_tpu_torch.get(refs, timeout=60) == list(range(64))
    from ray_tpu_torch.util import metrics
    text = metrics.prometheus_text()
    lines = text.splitlines()

    def value_of(prefix, tag=None):
        for ln in lines:
            if ln.startswith(prefix) and (tag is None or tag in ln):
                return float(ln.split()[-1])
        return None

    assert value_of("ray_tpu_serve_rps") is not None
    assert value_of("ray_tpu_serve_batch_size") > 1.0
    assert value_of("ray_tpu_serve_replicas",
                    'deployment="Echo"') == 2.0
    assert value_of("ray_tpu_serve_queue_depth",
                    'deployment="Echo"') is not None
    # second scrape: rps window sees the burst
    text2 = metrics.prometheus_text()
    assert any(ln.startswith("ray_tpu_serve_rps")
               for ln in text2.splitlines())
