"""The port's soak plane (``ray_tpu_torch.soak``) against
``tests/test_soak.py`` and the JAX package's ``ray_tpu.soak``.

The cases of ``tests/test_soak.py`` on the port: seeded schedule replay,
the oracle primitives, the tier-1 composed smoke (run with ``--device
cpu``: a CPU-only head) and the ``slow`` long run. Then the two packages
side by side: the same timeline records and digest for the same seed, the
same ``--dry-run`` output from both CLIs, the same values from both
oracles' parse of one Prometheus text.
"""

import json
import os
import subprocess
import sys

import pytest

from ray_tpu_torch._private.chaos import ChaosRule
from ray_tpu_torch.soak.schedule import (DIGEST_KINDS, fault_log_digest,
                                         generate_schedule, records_digest,
                                         write_timeline)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The reference smoke's pinned draw: at duration 14 this seed's schedule
# covers all six live scopes (test_smoke_seed_covers_every_scope).
SMOKE_SEED = 600
SMOKE_DURATION = 14.0

# Seeds and durations the two packages' schedules are compared at.
PARITY_DRAWS = [(seed, 20.0) for seed in range(12)] + [(SMOKE_SEED,
                                                         SMOKE_DURATION)]


# ---------------------------------------------------------------------------
# schedule generation + replay digest (dry-run side of the contract)


def test_same_seed_reproduces_byte_identical_timeline(tmp_path):
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    da = write_timeline(str(a), generate_schedule(7, 20.0))
    db = write_timeline(str(b), generate_schedule(7, 20.0))
    assert a.read_bytes() == b.read_bytes()     # byte-identical files
    assert da == db
    # and the file-side digest equals the in-memory schedule digest
    assert fault_log_digest(str(a)) == da


def test_different_seed_draws_a_different_schedule(tmp_path):
    s7 = generate_schedule(7, 20.0)
    s8 = generate_schedule(8, 20.0)
    assert s7.digest() != s8.digest()
    assert (s7.timeline_records() != s8.timeline_records())


def test_digest_ignores_fire_records_and_torn_lines(tmp_path):
    """Replay contract: ``fire`` records are load-dependent timing,
    excluded from the digest; a torn trailing line (a kill mid-write)
    must not break digesting either."""
    p = tmp_path / "log.jsonl"
    sched = generate_schedule(3, 12.0)
    want = write_timeline(str(p), sched)
    with open(p, "a", encoding="utf-8") as fh:
        fh.write(json.dumps({"kind": "fire", "component": "worker",
                             "point": "exec", "method": "churn_task",
                             "action": "kill", "pid": 12345}) + "\n")
        fh.write('{"kind": "arm", "torn')     # mid-write kill artifact
    assert fault_log_digest(str(p)) == want
    # but a genuinely different timeline record DOES change it
    recs = sched.timeline_records()
    recs[2] = dict(recs[2], t=recs[2]["t"] + 1.0)
    assert records_digest(recs) != want


def test_every_drawable_rule_parses_and_scopes_are_valid():
    """Each schedule draw must produce rules the port's chaos plane
    accepts, with scopes the runner knows how to arm."""
    for seed in range(12):
        sched = generate_schedule(seed, 20.0)
        for rule in sched.boot_rules:
            ChaosRule.parse(rule)
        assert sched.phases, "schedule drew no phases"
        assert sched.phases[0].scope == "churn"     # anchor phase
        for ph in sched.phases:
            assert ph.scope in ("driver", "churn", "serve",
                                "trainer", "autoscaler", "storm")
            for rule in ph.rules:
                ChaosRule.parse(rule)


def test_smoke_seed_covers_every_scope():
    scopes = {ph.scope for ph in
              generate_schedule(SMOKE_SEED, SMOKE_DURATION).phases}
    assert scopes == {"churn", "serve", "driver", "trainer",
                      "autoscaler", "storm"}


def test_cli_dry_run_prints_timeline_and_digest(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.soak", "--seed", "5",
         "--duration", "10", "--dry-run"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0
    records = [json.loads(ln) for ln in out.stdout.splitlines()]
    assert records[0]["kind"] == "schedule" and records[0]["seed"] == 5
    assert all(r["kind"] in DIGEST_KINDS for r in records)
    want = generate_schedule(5, 10.0).digest()
    assert f"digest: {want}" in out.stderr


# ---------------------------------------------------------------------------
# oracle primitives


def test_gauge_parsing_and_settle_primitives():
    from ray_tpu_torch.soak import oracle

    text = "\n".join([
        "# HELP ray_tpu_tasks tasks by state",
        'ray_tpu_tasks{state="running"} 3',
        'ray_tpu_tasks{state="backpressured"} 0',
        'ray_tpu_serve_queue_depth{deployment="D"} 2.5',
        "ray_tpu_uptime_seconds 12.5",
    ])
    assert oracle.gauge_value("ray_tpu_tasks", {"state": "running"},
                              text) == 3
    assert oracle.gauge_value("ray_tpu_serve_queue_depth",
                              {"deployment": "D"}, text) == 2.5
    assert oracle.gauge_value("ray_tpu_uptime_seconds", None,
                              text) == 12.5
    assert oracle.gauge_value("ray_tpu_tasks", {"state": "nope"},
                              text) is None
    # prefix names must not cross-match (ray_tpu_tasks vs _total etc.)
    assert oracle.gauge_samples("ray_tpu_task", text) == []

    # wait_settled: all probes must hold in the SAME round
    flaky = {"n": 0}

    def eventually():
        flaky["n"] += 1
        return flaky["n"] >= 3

    ok, detail = oracle.wait_settled(
        [("always", lambda: True), ("eventually", eventually)],
        timeout=5.0, interval=0.01)
    assert ok and detail == ""
    ok, detail = oracle.wait_settled(
        [("never", lambda: False)], timeout=0.2, interval=0.05)
    assert not ok and "never" in detail


def test_verdict_ok_conjunction_skips_skipped():
    from ray_tpu_torch.soak.oracle import InvariantResult, SoakVerdict

    v = SoakVerdict(seed=1, duration=5.0, invariants=[
        InvariantResult("a", True),
        InvariantResult("b", False, "disabled", skipped=True),
    ], counts={"fires": 2}, digest="d" * 64)
    assert v.ok
    v.invariants.append(InvariantResult("c", False, "boom"))
    assert not v.ok
    blob = json.loads(v.to_json())
    assert blob["ok"] is False
    assert [r["name"] for r in blob["invariants"]] == ["a", "b", "c"]
    assert "FAIL" in v.render() and "SKIP" in v.render()


# ---------------------------------------------------------------------------
# the composed smoke (tier-1): full mixed workload + chaos + oracle


def _run_soak(out_dir, seed, duration, extra_env=None):
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu",
                "RTPU_SANITIZE": "1",
                "RTPU_SANITIZE_LOG": os.path.join(out_dir, "san.jsonl")})
    env.pop("RTPU_CHAOS", None)         # a stray env rule would skew
    env.pop("RTPU_CHAOS_LOG", None)     # the replay digest
    env.update(extra_env or {})
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.soak", "--seed", str(seed),
         "--duration", str(duration), "--out", out_dir, "--report",
         "--device", "cpu"],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True,
        timeout=600)


def test_soak_smoke_all_invariants_hold(tmp_path):
    """~55 s composed smoke on a CPU-only head: seeded chaos over every
    subsystem with the oracle green — zero lost results, exactly-once
    side effects, gauges back at baseline, zero sanitizer violations,
    and the live fault log digesting to the dry-run regeneration."""
    out = _run_soak(str(tmp_path), SMOKE_SEED, SMOKE_DURATION)
    assert out.returncode == 0, (
        f"soak exited {out.returncode}\n--- stderr tail ---\n"
        + "\n".join(out.stderr.splitlines()[-30:]))
    verdict = json.loads(out.stdout)
    assert verdict["ok"] is True
    by_name = {r["name"]: r for r in verdict["invariants"]}
    for name in ("no-lost-results", "exactly-once-side-effects",
                 "gauges-at-baseline", "bounded-p99-inflation",
                 "graftsan-clean", "replayable-timeline"):
        r = by_name[name]
        assert r["ok"], f"{name}: {r['detail']}"
    # sanitized for real, not skipped
    assert by_name["graftsan-clean"]["skipped"] is False
    # chaos actually landed: the schedule is a plan, fires are ground
    # truth (at minimum the anchor churn kill + the boot-armed rules)
    assert verdict["counts"]["fires"] >= 1
    assert verdict["counts"]["phases"] >= 3
    # all lanes did real work; scale bursts completing proves parked
    # ELASTIC work un-fenced after the v2 scaler supplied capacity
    assert verdict["counts"]["ingress_ok"] > 50
    assert verdict["counts"]["churn_tasks_ok"] > 10
    assert verdict["counts"]["trainer_epochs_ok"] >= 1
    assert verdict["counts"]["scale_tasks_ok"] >= 1
    # the restart-storm lane: 8-consumer broadcasts sealed
    # byte-identical, and pull dedup collapsed the concurrent reads
    # onto in-flight fetches
    assert verdict["counts"]["storm_bcasts_ok"] >= 1
    assert verdict["counts"]["storm_pulls_deduped"] >= 1
    # replay contract, re-checked from the artifacts: live JSONL ==
    # dry-run regeneration from the same (seed, duration)
    live = fault_log_digest(os.path.join(str(tmp_path),
                                         "fault_events.jsonl"))
    assert live == generate_schedule(SMOKE_SEED, SMOKE_DURATION).digest()
    assert verdict["digest"] == live
    # the verdict artifact mirrors stdout
    with open(os.path.join(str(tmp_path), "verdict.json"),
              encoding="utf-8") as fh:
        assert json.load(fh) == verdict


@pytest.mark.slow
def test_soak_long_run(tmp_path):
    """The real soak: RTPU_SOAK_DURATION (default 60s) of composed
    chaos, seed from RTPU_SOAK_SEED. Excluded from tier-1."""
    seed = int(os.environ.get("RTPU_SOAK_SEED", "0"))
    duration = float(os.environ.get("RTPU_SOAK_DURATION", "60"))
    out = _run_soak(str(tmp_path), seed, duration)
    assert out.returncode == 0, (
        f"soak exited {out.returncode}\n--- stderr tail ---\n"
        + "\n".join(out.stderr.splitlines()[-40:]))
    verdict = json.loads(out.stdout)
    assert verdict["ok"] is True


# ---------------------------------------------------------------------------
# against the JAX package


@pytest.mark.parametrize("seed,duration", PARITY_DRAWS)
def test_schedule_matches_reference(tmp_path, seed, duration):
    """The same (seed, duration) draws the same timeline in both
    packages: records, the written file byte for byte, and the digest."""
    from ray_tpu.soak import schedule as ref
    ours = generate_schedule(seed, duration)
    theirs = ref.generate_schedule(seed, duration)
    assert ours.timeline_records() == theirs.timeline_records()
    assert ours.digest() == theirs.digest()
    a, b = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    assert write_timeline(str(a), ours) == ref.write_timeline(str(b), theirs)
    assert a.read_bytes() == b.read_bytes()


def test_weight_tables_match_reference():
    """The draw distribution, the boot pool, the version and the digest
    kinds are the reference's, entry for entry."""
    from ray_tpu.soak import schedule as ref
    from ray_tpu_torch.soak import schedule as port
    for ours, theirs in ((port.WEIGHTS, ref.WEIGHTS),
                         (port.BOOT_WEIGHTS, ref.BOOT_WEIGHTS)):
        assert [(s.key, s.template, s.scope, s.weight) for s in ours] == \
            [(s.key, s.template, s.scope, s.weight) for s in theirs]
    assert port.SCHEDULE_VERSION == ref.SCHEDULE_VERSION
    assert port.DIGEST_KINDS == ref.DIGEST_KINDS


def test_every_schedule_key_is_a_port_chaos_point():
    """The chaos-coverage pass counts each ``ArmSpec`` key as a test
    literal, so each must name a point the port's registry knows."""
    from ray_tpu_torch.devtools.analysis import contracts
    from ray_tpu_torch.devtools.analysis.passes.chaos_coverage import _needle
    from ray_tpu_torch.soak.schedule import BOOT_WEIGHTS, WEIGHTS
    needles = {_needle(p.get("component", "*"), p["point"],
                       p.get("detail", ""))
               for p in contracts.load_manifest()["chaos_points"]}
    missing = sorted(s.key for s in WEIGHTS + BOOT_WEIGHTS
                     if not any(n in s.key for n in needles))
    assert not missing, missing


@pytest.mark.parametrize("seed,duration", [(5, 10.0), (SMOKE_SEED,
                                                       SMOKE_DURATION)])
def test_cli_dry_run_matches_reference(seed, duration):
    """Both CLIs' ``--dry-run`` print the same records and digest."""
    outs = [subprocess.run(
        [sys.executable, "-m", package, "--seed", str(seed),
         "--duration", str(duration), "--dry-run"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=60,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
        for package in ("ray_tpu_torch.soak", "ray_tpu.soak")]
    assert [o.returncode for o in outs] == [0, 0]
    assert outs[0].stdout == outs[1].stdout
    assert [json.loads(ln) for ln in outs[0].stdout.splitlines()] == \
        generate_schedule(seed, duration).timeline_records()
    digests = [[ln for ln in o.stderr.splitlines()
                if ln.startswith("digest: ")] for o in outs]
    assert digests[0] == digests[1] and len(digests[0]) == 1


PROM_TEXT = "\n".join([
    "# HELP ray_tpu_tasks tasks by state",
    "# TYPE ray_tpu_tasks gauge",
    'ray_tpu_tasks{state="running"} 3',
    'ray_tpu_tasks{state="backpressured"} 0',
    'ray_tpu_tasks_total{state="finished"} 1.2e3',
    'ray_tpu_serve_queue_depth{deployment="SoakEcho"} 2.5',
    'ray_tpu_serve_queue_depth{deployment="SoakStream"} 0',
    'ray_tpu_object_pulls{state="deduped",node="a b"} 92',
    'ray_tpu_object_pulls{state="started", node="n1"} -1.5E-2',
    "ray_tpu_uptime_seconds 12.5",
    "ray_tpu_uptime_seconds_bad 12.5 trailing",
    "not_ours 7",
    "",
])


@pytest.mark.parametrize("name,labels", [
    ("ray_tpu_tasks", None), ("ray_tpu_tasks", {"state": "running"}),
    ("ray_tpu_tasks", {"state": "backpressured"}),
    ("ray_tpu_tasks", {"state": "nope"}),
    ("ray_tpu_tasks_total", {"state": "finished"}),
    ("ray_tpu_task", None),
    ("ray_tpu_serve_queue_depth", {"deployment": "SoakStream"}),
    ("ray_tpu_object_pulls", {"state": "deduped"}),
    ("ray_tpu_object_pulls", {"node": "n1"}),
    ("ray_tpu_uptime_seconds", None), ("ray_tpu_uptime_seconds_bad", None),
    ("not_ours", {}),
])
def test_oracle_parse_matches_reference(name, labels):
    """Both oracles read the same samples and values from one
    Prometheus text, and take the same percentiles."""
    from ray_tpu.soak import oracle as ref
    from ray_tpu_torch.soak import oracle as port
    assert port.gauge_samples(name, PROM_TEXT) == \
        ref.gauge_samples(name, PROM_TEXT)
    assert port.gauge_value(name, labels, PROM_TEXT) == \
        ref.gauge_value(name, labels, PROM_TEXT)
    xs = [0.3, 0.1, 0.25, 0.9, 0.05, 0.5]
    for q in (0.0, 0.5, 0.99, 1.0):
        assert port.percentile(xs, q) == ref.percentile(xs, q)
    assert port.percentile([], 0.99) is ref.percentile([], 0.99) is None
