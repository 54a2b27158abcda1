"""The port's chaos plane on the wire: the rule and RPC cases of
``tests/test_chaos.py`` (its lines 55-333) on ``ray_tpu_torch`` (rule
syntax and trigger counting, seeded probabilistic rules, phase scoping,
a retrying client that survives a severed connection, duplicated and
dropped frames resolved to one execution by idempotency tokens, delays,
the bounded dedupe cache, send failures). Its cluster cases are in
``test_torch_chaos_cluster.py``.
"""


import os
import time

import pytest
import torch

from ray_tpu_torch._private import chaos
from ray_tpu_torch._private.chaos import ChaosPlane, ChaosRule, ChaosRuleError
from ray_tpu_torch._private.rpc import (
    RetryingRpcClient,
    RpcClient,
    RpcServer,
    _DedupeCache,
)

@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _clean_chaos():
    """Every test starts and ends with a disarmed plane and no
    inherited env rules."""
    chaos.clear()
    os.environ.pop(chaos.ENV_VAR, None)
    yield
    chaos.clear()
    os.environ.pop(chaos.ENV_VAR, None)


# ---------------------------------------------------------------------------
# rule syntax + matcher (pure units)


def test_chaos_rule_parsing():
    r = ChaosRule.parse("gcs_client.send.kv_put:sever@2")
    assert (r.component, r.point, r.method) == ("gcs_client", "send",
                                                "kv_put")
    assert r.action == "sever" and r.after == 2 and r.count == 1

    r = ChaosRule.parse("raylet.dispatch.*:delay=0.25@3x5")
    assert r.action == "delay" and r.arg == 0.25
    assert r.after == 3 and r.count == 5

    r = ChaosRule.parse("worker.exec.doom*:killx*")
    assert r.action == "kill" and r.count == -1
    assert r.matches("worker", "exec", "doomed_task")
    assert not r.matches("worker", "exec", "innocent")

    for bad in ("nonsense", "a.b.c:explode", "a.b:drop", "a.b.c:drop@0"):
        with pytest.raises(ChaosRuleError):
            ChaosRule.parse(bad)


def test_chaos_trigger_counting():
    plane = ChaosPlane()
    plane.install("c.send.m:drop@3x2")
    out = [plane.fire("c", "send", "m") for _ in range(6)]
    assert out == [None, None, "drop", "drop", None, None]
    assert [e[3] for e in plane.events] == ["drop", "drop"]


def test_chaos_probabilistic_rules_reproduce_under_fixed_seed():
    def run(seed):
        plane = ChaosPlane()
        plane.install([ChaosRule("c", "send", "m", "drop",
                                 count=-1, prob=0.5)], seed=seed)
        return [plane.fire("c", "send", "m") for _ in range(32)]

    a, b = run(1234), run(1234)
    assert a == b                       # fixed seed: identical sequence
    assert "drop" in a and None in a    # and genuinely probabilistic
    assert run(99) != a                 # different seed: different draw


def test_chaos_phase_scoping_preserves_unphased_rules_and_counters():
    """install_phase/clear_phase operate ONLY on their phase's rules:
    unphased rules survive with their live trigger counters intact
    (a phase swap mid-soak must not reset another rule's @after
    progress), and clearing one phase leaves a different phase armed."""
    plane = ChaosPlane()
    plane.install("c.send.base:drop@3x*")
    plane.fire("c", "send", "base")     # matched=1: counter progress
    plane.fire("c", "send", "base")     # matched=2

    plane.install_phase("p0", "c.send.a:drop")
    plane.install_phase("p1", ["c.send.b:drop", "c.send.bb:sever"])
    assert len(plane.rules()) == 4

    # replacing a phase swaps ONLY that phase's rules
    plane.install_phase("p0", "c.send.a2:dup")
    methods = {r.method for r in plane.rules()}
    assert methods == {"base", "a2", "b", "bb"}

    assert plane.clear_phase("p1") == 2
    assert plane.clear_phase("p1") == 0     # idempotent
    methods = {r.method for r in plane.rules()}
    assert methods == {"base", "a2"}

    # the unphased rule kept its counter: third match fires
    assert plane.fire("c", "send", "base") == "drop"
    assert plane.armed
    plane.clear_phase("p0")
    assert plane.armed                      # unphased rule still there


def test_chaos_phase_swap_atomic_under_concurrent_fire():
    """A fire() racing install_phase/clear_phase churn observes either
    the whole old rule set or the whole new one — never a torn state
    where one of a phase's two complementary rules is installed
    without the other. The two rules match DISTINCT methods fired
    back-to-back; a torn swap shows up as exactly one of the pair
    acting."""
    import threading

    plane = ChaosPlane()
    stop = threading.Event()
    torn = []

    def swapper():
        while not stop.is_set():
            plane.install_phase(
                "p", ["c.send.x:drop@1x*", "c.send.y:drop@1x*"])
            plane.clear_phase("p")

    threads = [threading.Thread(target=swapper) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        for _ in range(3000):
            a = plane.fire("c", "send", "x")
            b = plane.fire("c", "send", "y")
            # complete-set check is statistical across the pair: both
            # present or both absent is consistent; we tolerate a swap
            # BETWEEN the two fires (a!=b with a whole set installed),
            # so assert the plane itself never exposes a partial list
            rules = plane.rules()
            if {r.phase for r in rules} == {"p"} and len(rules) == 1:
                torn.append((a, b, [r.method for r in rules]))
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not torn, f"partial phase rule set observed: {torn[:3]}"


# ---------------------------------------------------------------------------
# transport hardening (rpc layer units)


def test_retrying_client_survives_severed_connection():
    """Acceptance (a), unit level: a severed connection reconnects
    with backoff and the in-flight call re-sends under its token."""
    server = RpcServer(component="unit_server")
    server.register("echo", lambda ctx, x: x * 2)
    client = RetryingRpcClient(server.address, component="unit_client")
    try:
        assert client.call("echo", 1, timeout=10) == 2
        chaos.install("unit_client.send.echo:sever@1")
        assert client.call("echo", 21, timeout=15) == 42
        assert client.num_reconnects == 1
        assert ("unit_client", "send", "echo", "sever") in chaos.events()
    finally:
        client.close()
        server.shutdown()


def test_duplicated_submit_frame_executes_once():
    """Acceptance (b): the submit frame is literally doubled on the
    wire; the idempotency token + server dedupe cache collapse it to
    one execution, and the hit is observable."""
    server = RpcServer(component="dup_server")
    executions = []
    server.register("submit",
                    lambda ctx, p: (executions.append(p), "ok")[1])
    client = RetryingRpcClient(server.address, component="dup_client")
    try:
        chaos.install("dup_client.send.submit:dup@1")
        assert client.call("submit", {"task": 1}, timeout=10) == "ok"
        deadline = time.monotonic() + 5
        while server.dedupe_hits < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert executions == [{"task": 1}]
        assert server.dedupe_hits == 1
    finally:
        client.close()
        server.shutdown()


def test_duplicated_frame_without_token_runs_twice():
    """The contrast case documenting WHY submits carry tokens: a bare
    RpcClient (no idempotency) executes a duplicated frame twice."""
    server = RpcServer(component="dup2_server")
    executions = []
    server.register("submit",
                    lambda ctx, p: (executions.append(p), "ok")[1])
    client = RpcClient(server.address, component="dup2_client")
    try:
        chaos.install("dup2_client.send.submit:dup@1")
        assert client.call("submit", 7, timeout=10) == "ok"
        deadline = time.monotonic() + 5
        while len(executions) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert executions == [7, 7]
        assert server.dedupe_hits == 0
    finally:
        client.close()
        server.shutdown()


def test_dropped_reply_replays_from_dedupe_cache():
    """A reply lost in flight: the client re-sends after its attempt
    slice; the server recognizes the token and replays the recorded
    outcome — the handler still ran exactly once."""
    server = RpcServer(component="drop_server")
    executions = []
    server.register("bump",
                    lambda ctx: (executions.append(1), len(executions))[1])
    client = RetryingRpcClient(server.address, component="drop_client",
                               attempt_timeout=0.5)
    try:
        chaos.install("drop_server.send.reply:drop@1")
        assert client.call("bump", timeout=15) == 1
        assert executions == [1]
        assert server.dedupe_hits == 1
    finally:
        client.close()
        server.shutdown()


def test_delay_rule_stalls_but_call_survives():
    server = RpcServer(component="slow_server")
    server.register("ping", lambda ctx: "pong")
    client = RetryingRpcClient(server.address, component="slow_client")
    try:
        chaos.install("slow_server.dispatch.ping:delay=0.3@1")
        t0 = time.monotonic()
        assert client.call("ping", timeout=10) == "pong"
        assert time.monotonic() - t0 >= 0.3
    finally:
        client.close()
        server.shutdown()


def test_dedupe_cache_bounded_lru():
    cache = _DedupeCache(capacity=4)
    for i in range(10):
        assert cache.begin(f"t{i}") is None
        cache.finish(f"t{i}", True, i)
    assert len(cache) == 4
    assert cache.begin("t9") == (True, 9)       # recent entry replayed
    assert cache.begin("t0") is None            # evicted: re-executes


# ---------------------------------------------------------------------------
# satellite fixes (rpc client hygiene)


def test_call_send_failure_cleans_pending_waiter():
    server = RpcServer()
    server.register("ping", lambda ctx: "pong")
    client = RpcClient(server.address)
    try:
        assert client.call("ping", timeout=5) == "pong"
        client._sock.close()        # transport dies under the client
        with pytest.raises(ConnectionError):
            client.call("ping", timeout=5)
        assert client._pending == {}        # no leaked waiter
    finally:
        client.close()
        server.shutdown()


def test_oneway_surfaces_connection_error():
    server = RpcServer()
    server.register("note", lambda ctx, m: None)
    client = RpcClient(server.address)
    client.oneway("note", "fine")
    server.shutdown()
    deadline = time.monotonic() + 5
    while client.alive and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(ConnectionError):
        client.oneway("note", "into the void")
    client.close()


def test_wait_for_server_backoff_and_deadline_clamp(monkeypatch):
    from ray_tpu_torch._private import rpc as rpc_mod

    attempts = []

    def refuse(addr, timeout=None):
        attempts.append(timeout)
        raise OSError("refused")

    monkeypatch.setattr(rpc_mod.socket, "create_connection", refuse)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        rpc_mod.wait_for_server(("127.0.0.1", 1), timeout=0.6)
    assert 0.5 <= time.monotonic() - t0 < 3.0
    # exponential spacing: far fewer probes than the old fixed 50ms
    # cadence (12) would have made
    assert 2 <= len(attempts) <= 8
    # each probe's connect timeout is clamped to the remaining deadline
    assert all(t <= 1.0 for t in attempts)
    assert attempts[-1] <= 0.6


# ---------------------------------------------------------------------------
# gcs channel: sever -> reconnect + re-subscribe + re-register


