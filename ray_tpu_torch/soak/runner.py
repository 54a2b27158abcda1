"""The soak runner: composes the cluster, the three workload drivers,
the seeded chaos schedule, and the invariant oracle into one run with
a typed verdict.

Counterpart of ``ray_tpu/soak/runner.py``. The head runs on the card-owning
runtime: ``SoakConfig.device`` is ``"cuda"`` by default, and the head then
owns the detected cards (``init`` raises without one); ``"cpu"`` starts a
CPU-only head (``num_gpus=0``). No lane asks for ``GPU``: the reference's
8 TPUs are a logical count that nothing demands, so the port's head carries
only what ``init`` detects, and the remote node stays CPU-only.

A run's shape (ray_tpu_torch/docs/soak.md has the operator view):

1. **bring-up** — a mixed cluster: an in-process head (serve + the
   2-slice trainer live here) plus ONE real remote node (raylet +
   standalone GCS processes) carrying the churn lane over the real
   wire. The schedule's boot rules are env-armed around the remote
   spawn — their ``@after`` counts phase them in logical time.
2. **warm-up** — all three drivers run calm; the ingress's calm
   latency window is the p99 baseline.
3. **phases** — for each window of the schedule: emit the digest-
   stable ``arm`` record, apply the rules in the window's scope,
   sleep the window, emit ``disarm``, remove the rules, then run a
   settle check (ingress paused) asserting every live ``ray_tpu_*``
   gauge returns to baseline before the next window.
4. **drain + verdict** — stop the drivers, require a full quiesce
   (serve + backpressure + data-plane gauges), then assemble the
   :class:`~ray_tpu_torch.soak.oracle.SoakVerdict`: lost results,
   exactly-once ledgers, gauge baselines, p99 inflation, graftsan,
   and the replay digest (live log vs dry-run regeneration).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch._private import chaos
from ray_tpu_torch.soak import oracle
from ray_tpu_torch.soak.schedule import (Schedule, fault_log_digest,
                                   generate_schedule)
from ray_tpu_torch.soak.workloads import (ChurnDriver, IngressDriver,
                                    ScaleDriver, StormDriver,
                                    TrainerDriver, build_serve_apps,
                                    serve_chaos_arm, serve_chaos_disarm)


@dataclasses.dataclass
class SoakConfig:
    seed: int = 0
    duration: float = 14.0          # chaos-window length (s)
    out_dir: str = "soak_out"
    warmup_s: float = 3.0
    http_period_s: float = 0.03
    settle_timeout_s: float = 30.0
    drain_timeout_s: float = 60.0
    # p99 inflation bound (chaos p99 / calm p99); None = report-only
    p99_inflation_max: Optional[float] = None
    device: str = "cuda"            # the head's runtime: "cuda" or "cpu"

    @property
    def event_log(self) -> str:
        return os.path.join(self.out_dir, "fault_events.jsonl")


class SoakRunner:
    def __init__(self, config: SoakConfig):
        self.cfg = config
        self.schedule: Optional[Schedule] = None
        self.phase_settles: List[Tuple[str, bool, str]] = []

    # -- lifecycle ----------------------------------------------------

    def run(self) -> oracle.SoakVerdict:
        cfg = self.cfg
        os.makedirs(cfg.out_dir, exist_ok=True)
        ledger_dir = os.path.join(cfg.out_dir, "ledger")
        arm_dir = os.path.join(cfg.out_dir, "arm")
        for d in (ledger_dir, arm_dir):
            os.makedirs(d, exist_ok=True)
            for fn in os.listdir(d):    # a prior run's ledger entries
                try:                    # would read as stray effects
                    os.unlink(os.path.join(d, fn))
                except OSError:
                    pass
        if os.path.exists(cfg.event_log):
            os.unlink(cfg.event_log)    # stale records would skew digest

        self.schedule = generate_schedule(cfg.seed, cfg.duration)

        # attach the fault-event log BEFORE any spawn so every child
        # inherits RTPU_CHAOS_LOG and mirrors its fire records
        os.environ[chaos.ENV_LOG_VAR] = cfg.event_log
        chaos.set_event_log(cfg.event_log)
        chaos.log_event(self.schedule.header_record())

        cluster = None
        ingress = trainer = churn = scale = storm = None
        try:
            cluster = self._bring_up()
            # trainer first: its two slice workers claim head pool
            # slots while serve is still deploying, so epoch 1 starts
            # promptly instead of queueing behind the replicas
            trainer = TrainerDriver()
            trainer.start()
            deployments = build_serve_apps()
            ingress = IngressDriver(period_s=cfg.http_period_s).start()
            churn = ChurnDriver(ledger_dir, arm_dir)
            churn.start()
            # the autoscaling lane: ELASTIC bursts that only complete
            # if the v2 scaler supplies (and later drains) capacity
            scale = ScaleDriver(cluster).start()
            # the broadcast lane: 8 concurrent consumers of one fresh
            # remote object per cycle (pull dedup + storm-scope chaos)
            storm = StormDriver().start()

            time.sleep(cfg.warmup_s)        # calm p99 baseline window
            ingress.calm = False
            self._run_phases(ingress, trainer, churn, deployments)
            return self._finish(ingress, trainer, churn, scale, storm,
                                deployments)
        finally:
            if storm is not None:
                try:
                    storm.stop()
                    storm.join(timeout=120)
                except Exception:
                    pass    # teardown best effort
            if scale is not None:
                try:
                    scale.stop()
                    scale.join(timeout=90)
                    scale.shutdown_scaler()
                except Exception:
                    pass    # teardown best effort
            for drv in (ingress, churn, trainer):
                try:
                    if drv is not None:
                        drv.stop()
                except Exception:
                    pass    # teardown best effort
            for drv, t in ((churn, 30), (trainer, 120)):
                try:
                    if drv is not None:
                        drv.join(timeout=t)
                except Exception:
                    pass    # teardown best effort
            try:
                from ray_tpu_torch import serve
                serve.shutdown()
            except Exception:
                pass    # teardown best effort
            if cluster is not None:
                try:
                    cluster.shutdown()
                except Exception:
                    pass    # teardown best effort
            os.environ.pop(chaos.ENV_LOG_VAR, None)
            chaos.set_event_log(None)
            chaos.clear()

    def _bring_up(self):
        from ray_tpu_torch._private.device import resolve_device
        from ray_tpu_torch.cluster_utils import Cluster
        # "cuda": the head owns the detected cards; "cpu": none
        cards = ({} if resolve_device(self.cfg.device).type == "cuda"
                 else {"num_gpus": 0})
        # 8 process slots: 2 trainer workers + 3 serve replicas are
        # long-lived; the rest serve data-pipeline map tasks
        cluster = Cluster(head_num_cpus=8, max_process_workers=8, **cards)
        # env-arm the boot rules ONLY around the remote spawn: the
        # raylet + GCS processes inherit them; the driver must not
        os.environ[chaos.ENV_VAR] = ";".join(self.schedule.boot_rules)
        os.environ[chaos.ENV_SEED_VAR] = str(self.cfg.seed)
        try:
            cluster.add_node(num_cpus=4, resources={"CHURN": 100},
                             remote=True, max_process_workers=2)
        finally:
            os.environ.pop(chaos.ENV_VAR, None)
            os.environ.pop(chaos.ENV_SEED_VAR, None)
        chaos.log_event(self.schedule.boot_record())
        return cluster

    # -- the chaos window ---------------------------------------------

    def _run_phases(self, ingress, trainer, churn, deployments) -> None:
        t0 = time.monotonic()
        pending_trainer = []        # completion events still in flight
        for ph in self.schedule.phases:
            self._sleep_until(t0 + ph.start)
            chaos.log_event(ph.arm_record())
            undo = self._arm(ph, trainer, churn, pending_trainer)
            self._sleep_until(t0 + ph.start + ph.duration)
            chaos.log_event(ph.disarm_record())
            undo()
            self._settle(ph.name, ingress, deployments)
        # a trainer epoch may outlive its window — wait for the last
        # inject to fully arm+disarm before the final drain
        for ev in pending_trainer:
            ev.wait(timeout=180)

    @staticmethod
    def _sleep_until(deadline: float) -> None:
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                return
            time.sleep(min(left, 0.25))

    def _arm(self, ph, trainer, churn, pending_trainer):
        """Apply one phase's rules in its scope; returns the disarm
        thunk. Arm failures degrade to a no-op phase (recorded in the
        timeline either way — the digest is about the SCHEDULE, not
        about every fault landing)."""
        if ph.scope in ("driver", "autoscaler", "storm"):
            # autoscaler-scope provider points are site-applied in the
            # driver process (FakeCloudProvider lives here) and
            # storm-scope transfer points fire in the pulling process
            # (the StormDriver's consumers pull through the driver's
            # PullManager), so the same install_phase route reaches
            # all three
            chaos.install_phase(ph.name, ph.rules)
            return lambda: chaos.clear_phase(ph.name)
        if ph.scope == "churn":
            names = churn.arm(ph.rules, ph.name)
            return lambda: churn.disarm(names)
        if ph.scope == "serve":
            for rule in ph.rules:
                try:
                    serve_chaos_arm("SoakEcho", rule)
                except Exception:
                    pass    # replica mid-respawn: phase becomes a no-op
            return lambda: serve_chaos_disarm("SoakEcho")
        if ph.scope == "trainer":
            ev = trainer.inject(ph.rules)
            pending_trainer.append(ev)
            # the TrainerDriver disarms every rank itself after the
            # faulted epoch; the phase end just bounds the wait
            return lambda: ev.wait(timeout=1.0)
        return lambda: None

    def _settle(self, phase_name, ingress, deployments) -> None:
        paused = ingress.pause(timeout=self.cfg.settle_timeout_s)
        probes = oracle.serve_settle_probes(deployments)
        probes.append(oracle.backpressure_settle_probe())
        ok, detail = oracle.wait_settled(
            probes, timeout=self.cfg.settle_timeout_s)
        if not paused:
            ok, detail = False, "ingress failed to drain; " + detail
        self.phase_settles.append((phase_name, ok, detail))
        ingress.resume()

    # -- verdict ------------------------------------------------------

    def _finish(self, ingress, trainer, churn, scale, storm,
                deployments) -> oracle.SoakVerdict:
        cfg = self.cfg
        ingress.stop()
        storm.stop()
        storm.join(timeout=120)     # an in-flight broadcast rides out
        churn.stop()
        churn.join(timeout=60)
        churn.sweep()
        scale.stop()
        scale.join(timeout=90)      # a burst mid-relaunch rides out
        scale.shutdown_scaler()
        trainer.stop()
        trainer.join(timeout=180)

        probes = oracle.serve_settle_probes(deployments)
        probes.append(oracle.backpressure_settle_probe())
        probes.append(oracle.data_drained_probe())
        drained, drain_detail = oracle.wait_settled(
            probes, timeout=cfg.drain_timeout_s)

        inv: List[oracle.InvariantResult] = []

        lost = (list(ingress.lost) + list(churn.lost)
                + list(trainer.failures) + list(scale.lost)
                + list(storm.lost))
        inv.append(oracle.InvariantResult(
            "no-lost-results", not lost,
            "; ".join(lost[:5]) + (" …" if len(lost) > 5 else "")))

        ledger_ok, ledger_detail = churn.ledger_ok()
        once_ok = ledger_ok and trainer.numerics_ok
        detail = ledger_detail
        if not trainer.numerics_ok:
            detail = (detail + "; " if detail else "") + \
                "trainer state off the analytic total"
        inv.append(oracle.InvariantResult(
            "exactly-once-side-effects", once_ok, detail))

        bad = [f"{name}: {d}" for name, ok, d in self.phase_settles
               if not ok]
        if not drained:
            bad.append(f"final drain: {drain_detail}")
        inv.append(oracle.InvariantResult(
            "gauges-at-baseline", not bad, "; ".join(bad[:3])))

        inv.append(self._p99_invariant(ingress))

        count, san_detail = oracle.graftsan_violations()
        inv.append(oracle.InvariantResult(
            "graftsan-clean",
            ok=(count == 0), detail=san_detail,
            skipped=(count is None)))

        live = fault_log_digest(cfg.event_log)
        want = self.schedule.digest()
        inv.append(oracle.InvariantResult(
            "replayable-timeline", live == want,
            "" if live == want else f"log {live[:12]} != "
                                    f"schedule {want[:12]}"))

        counts: Dict[str, float] = {}
        for drv in (ingress, trainer, churn, scale, storm):
            counts.update(drv.stats())
        counts["fires"] = self._count_fires()
        counts["phases"] = len(self.schedule.phases)

        verdict = oracle.SoakVerdict(
            seed=cfg.seed, duration=cfg.duration,
            invariants=inv, counts=counts, digest=want)
        with open(os.path.join(cfg.out_dir, "verdict.json"), "w",
                  encoding="utf-8") as fh:
            fh.write(verdict.to_json() + "\n")
        return verdict

    def _p99_invariant(self, ingress) -> oracle.InvariantResult:
        calm = oracle.percentile(ingress.latencies_calm, 0.99)
        chaotic = oracle.percentile(ingress.latencies_chaos, 0.99)
        if calm is None or chaotic is None or calm <= 0:
            return oracle.InvariantResult(
                "bounded-p99-inflation", True,
                "insufficient latency samples", skipped=True)
        ratio = chaotic / calm
        detail = (f"calm p99 {calm * 1e3:.1f}ms, chaos p99 "
                  f"{chaotic * 1e3:.1f}ms ({ratio:.1f}x)")
        bound = self.cfg.p99_inflation_max
        if bound is None:
            return oracle.InvariantResult(
                "bounded-p99-inflation", True, detail + " [report-only]")
        return oracle.InvariantResult(
            "bounded-p99-inflation", ratio <= bound,
            detail + f" bound {bound}x")

    def _count_fires(self) -> int:
        n = 0
        try:
            with open(self.cfg.event_log, encoding="utf-8") as fh:
                for line in fh:
                    try:
                        if json.loads(line).get("kind") == "fire":
                            n += 1
                    except ValueError:
                        continue    # torn concurrent write
        except OSError:
            pass
        return n
