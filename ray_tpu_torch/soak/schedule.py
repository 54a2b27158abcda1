"""Seeded chaos schedules over the machine-checked chaos-point
registry, plus the replayable fault-timeline contract.

A **schedule** is a deterministic function of ``(seed, duration)``:

- a set of **boot rules** — armed through the environment when the
  remote raylet spawns, because server-side points (``raylet.dispatch``,
  ``raylet.recv``, the watchdog's ``pressure`` sampling) live in a
  process the driver cannot re-arm mid-run; their ``@after`` event
  counts phase them in logical time instead of wall time;
- a sequence of **phases**, each a ``(start, duration, scope, rules)``
  window. At the phase boundary the runner arms the rules in the
  named scope and disarms them at the window's end:

  ==========  =====================================================
  scope       how the rules reach the faulted process
  ==========  =====================================================
  ``driver``  ``chaos.install_phase()`` in the driver (client-side
              wire faults: the rpc send/recv hook sites)
  ``churn``   an arm-file the next churn-lane worker claims and
              installs in its own process (one worker, one kill)
  ``serve``   a direct per-replica call installs the rule inside
              one live replica
  ``trainer`` the TrainerDriver arms ALL ranks at the next epoch
              boundary — the real rule on the victim, an ``@999``
              placeholder on peers for checkpoint call symmetry
  ``autoscaler``  ``chaos.install_phase()`` in the driver, like
              ``driver`` — the FakeCloudProvider's site-applied
              ``provider`` points live in the driver process
  ``storm``   ``chaos.install_phase()`` in the driver, like
              ``driver`` — ``object.transfer.fetch`` fires in the
              pulling process, and the StormDriver's broadcast
              consumers pull through the driver's PullManager
  ==========  =====================================================

The **weight table** below is the draw distribution. Every entry
names the registry key (``contracts.json`` ``chaos_points``) it
exercises as a literal, so the graftcheck chaos-coverage pass counts
soak-schedule entries as exercisers.

**Replay contract**: the runner mirrors the schedule into the JSONL
fault-event log as ``kind in {"schedule", "arm", "disarm"}`` records
carrying only logical fields (phase index, planned offset, rule
strings) — never wall-clock times or pids. ``fault_log_digest``
hashes exactly those records, so the digest of a live run equals the
digest of a dry-run regeneration from the same seed. ``kind="fire"``
records (written by the chaos plane as faults actually land, from
any process) are informational and excluded: fault *timing* is
load-dependent, the fault *timeline* is not.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import random
from typing import Dict, List, Optional, Sequence, Tuple

SCHEDULE_VERSION = 3   # v3: storm scope (object pull-plane chaos)

# record kinds covered by the replay digest (logical timeline only)
DIGEST_KINDS = frozenset({"schedule", "arm", "disarm"})


@dataclasses.dataclass(frozen=True)
class ArmSpec:
    """One drawable entry: the registry key it exercises, the rule
    template (``{after}`` filled at draw time), its scope + weight."""

    key: str
    template: str
    scope: str
    weight: float


# The draw distribution. Literal registry keys on purpose — the
# chaos-coverage pass scans this table as test-literal coverage.
WEIGHTS: Tuple[ArmSpec, ...] = (
    # -- driver scope: client-side wire faults ------------------------
    ArmSpec("raylet_channel.send.submit_many",
            "raylet_channel.send.submit*:drop@{after}", "driver", 3.0),
    ArmSpec("raylet_channel.send.submit_many",
            "raylet_channel.send.submit*:dup@{after}", "driver", 3.0),
    ArmSpec("raylet_channel.send.task_done",
            "raylet_channel.send.*:sever@{after}", "driver", 2.0),
    ArmSpec("gcs_client.send.kv_put",
            "gcs_client.send.kv_*:sever@{after}", "driver", 1.0),
    ArmSpec("raylet_channel.send.stats",
            "raylet_channel.send.*:delay=0.05@{after}x3", "driver", 2.0),
    # -- churn scope: worker-process deaths at exec entry -------------
    ArmSpec("worker.exec.churn_task",
            "worker.exec.churn_task:kill@{after}", "churn", 4.0),
    # -- serve scope: replica death mid-traffic -----------------------
    ArmSpec("worker.exec.ReplicaActor.handle_request",
            "worker.exec.ReplicaActor.handle_request*:kill@1",
            "serve", 2.0),
    # -- trainer scope: gang aborts + cross-slice faults. Only faults
    # the recovery taxonomy handles TYPED are drawable: kills (a dead
    # member fences the epoch via liveness) and dcn load drops (the
    # reader writes the abort marker itself). A rendezvous/dcn *save*
    # drop with no death behind it has no peer signal on a 1-rank
    # slice and would burn the full collective timeout instead.
    ArmSpec("multislice.dcn.save_ar",
            "multislice.dcn.save_*:kill@1", "trainer", 2.0),
    ArmSpec("multislice.dcn.load_ar",
            "multislice.dcn.load_*:drop@1", "trainer", 2.0),
    ArmSpec("collective.rendezvous.save_ar",
            "collective.rendezvous.save_*:kill@1", "trainer", 1.0),
    ArmSpec("actor.checkpoint.save",
            "actor.checkpoint.save:kill@{after}", "trainer", 1.0),
    # -- autoscaler scope: provider faults (site-applied, armed via
    # install_phase in the driver — the FakeCloudProvider lives there;
    # docs/autoscaler.md). A dropped launch must converge through the
    # REQUESTED deadline + retry budget; boot-then-die through the
    # `gone` observation.
    ArmSpec("autoscaler.provider.launch",
            "autoscaler.provider.launch:drop@{after}", "autoscaler", 2.0),
    ArmSpec("autoscaler.provider.launch",
            "autoscaler.provider.launch:delay=0.2@{after}",
            "autoscaler", 1.0),
    ArmSpec("autoscaler.provider.boot",
            "autoscaler.provider.boot:kill@{after}", "autoscaler", 1.0),
    # -- storm scope: object pull-plane faults. Armed via
    # install_phase in the driver — chaos on object.transfer.fetch
    # fires in the PULLING process, and the StormDriver's 8-consumer
    # broadcast pulls run in the driver's PullManager. Drops and
    # severs must converge through the seeded-backoff retry/failover
    # path with every consumer still sealing byte-identical copies
    # (docs/object_plane.md).
    ArmSpec("object.transfer.fetch",
            "object.transfer.fetch:drop@{after}x2", "storm", 2.0),
    ArmSpec("object.transfer.fetch",
            "object.transfer.fetch:delay=0.05@{after}x3", "storm", 1.0),
    ArmSpec("object.transfer.fetch",
            "object.transfer.fetch:sever@{after}", "storm", 1.0),
)

# boot-scope pool: armed once in the remote raylet's environment at
# spawn (server-side points the driver cannot reach mid-run)
BOOT_WEIGHTS: Tuple[ArmSpec, ...] = (
    ArmSpec("raylet.dispatch.submit_many",
            "raylet.dispatch.submit*:drop@{after}", "boot", 2.0),
    ArmSpec("raylet.recv.submit_many",
            "raylet.recv.*:sever@{after}", "boot", 1.0),
    ArmSpec("raylet.watchdog.sample1",
            "raylet.watchdog.sample*:pressure=0.99@{after}", "boot", 1.0),
)


@dataclasses.dataclass
class Phase:
    """One arm/disarm window of the schedule."""

    index: int
    start: float        # planned offset from chaos-window start (s)
    duration: float
    scope: str
    rules: Tuple[str, ...]

    @property
    def name(self) -> str:
        return f"p{self.index}"

    def arm_record(self) -> Dict:
        return {"kind": "arm", "phase": self.name, "i": self.index,
                "t": self.start, "scope": self.scope,
                "rules": list(self.rules)}

    def disarm_record(self) -> Dict:
        return {"kind": "disarm", "phase": self.name, "i": self.index,
                "t": round(self.start + self.duration, 3),
                "scope": self.scope}


@dataclasses.dataclass
class Schedule:
    """The full deterministic timeline for one ``(seed, duration)``."""

    seed: int
    duration: float
    boot_rules: Tuple[str, ...]
    phases: List[Phase]

    def header_record(self) -> Dict:
        return {"kind": "schedule", "v": SCHEDULE_VERSION,
                "seed": self.seed, "duration": self.duration,
                "phases": len(self.phases)}

    def boot_record(self) -> Dict:
        return {"kind": "arm", "phase": "boot", "i": -1, "t": 0.0,
                "scope": "boot", "rules": list(self.boot_rules)}

    def timeline_records(self) -> List[Dict]:
        """Every digest-stable record, in the order the runner emits
        them during a live run."""
        out = [self.header_record(), self.boot_record()]
        for ph in self.phases:
            out.append(ph.arm_record())
            out.append(ph.disarm_record())
        return out

    def digest(self) -> str:
        return records_digest(self.timeline_records())


def _weighted_choice(rng: random.Random,
                     specs: Sequence[ArmSpec]) -> ArmSpec:
    total = sum(s.weight for s in specs)
    x = rng.random() * total
    for s in specs:
        x -= s.weight
        if x <= 0:
            return s
    return specs[-1]


def _render(rng: random.Random, spec: ArmSpec) -> str:
    return spec.template.format(after=rng.randint(1, 4))


def generate_schedule(seed: int, duration: float,
                      min_phase_s: float = 2.0,
                      max_phase_s: float = 4.0) -> Schedule:
    """Draw the schedule for ``(seed, duration)``. Pure function of
    its arguments — no clocks, no environment."""
    rng = random.Random(seed)
    boot = tuple(_render(rng, s)
                 for s in rng.sample(list(BOOT_WEIGHTS),
                                     k=min(2, len(BOOT_WEIGHTS))))
    phases: List[Phase] = []
    t = 0.0
    idx = 0
    while t < duration:
        dur = round(rng.uniform(min_phase_s, max_phase_s), 3)
        if idx == 0:
            # anchor phase: a churn-lane kill ALWAYS opens the run, so
            # every seed provably injects at least one fault into a
            # continuously active lane
            spec = next(s for s in WEIGHTS if s.scope == "churn")
        else:
            spec = _weighted_choice(rng, WEIGHTS)
        rules = [_render(rng, spec)]
        # occasionally pile a second same-scope rule into the window
        if rng.random() < 0.25:
            peers = [s for s in WEIGHTS
                     if s.scope == spec.scope and s is not spec]
            if peers:
                rules.append(_render(rng, rng.choice(peers)))
        phases.append(Phase(index=idx, start=round(t, 3), duration=dur,
                            scope=spec.scope, rules=tuple(rules)))
        t += dur
        idx += 1
    return Schedule(seed=seed, duration=duration, boot_rules=boot,
                    phases=phases)


# ---------------------------------------------------------------------------
# digesting


def _canon(record: Dict) -> str:
    return json.dumps(record, sort_keys=True)


def records_digest(records: Sequence[Dict]) -> str:
    h = hashlib.sha256()
    for rec in records:
        if rec.get("kind") in DIGEST_KINDS:
            h.update(_canon(rec).encode())
            h.update(b"\n")
    return h.hexdigest()


def fault_log_digest(path: str) -> str:
    """Digest of a fault-event JSONL file: only the digest-stable
    kinds count (see module docstring); ``fire`` records and torn
    trailing lines are skipped."""
    records: List[Dict] = []
    try:
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except ValueError:
                    continue    # torn concurrent write
    except OSError:
        return records_digest([])
    return records_digest(records)


def write_timeline(path: str, schedule: Schedule) -> str:
    """Dry-run helper: write the full deterministic timeline to
    ``path`` and return its digest (what a live run's log digests to)."""
    with open(path, "w", encoding="utf-8") as fh:
        for rec in schedule.timeline_records():
            fh.write(_canon(rec) + "\n")
    return schedule.digest()
