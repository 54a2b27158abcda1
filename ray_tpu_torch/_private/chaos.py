"""Chaos plane: deterministic, seedable fault injection for the wire
and process layers.

Reference analog: the reference's failure tests reach into raylets
with ``kill -9`` and OS-level network partitions; this runtime instead
carries its own injection points so every failure path is exercisable
deterministically in-process and cross-process (the raylet/GCS/worker
children inherit the rules through the environment).

A **rule** names an event and an action::

    component.point.method:action[=arg][@after][xCount]

- ``component``: who fires the event — ``gcs_client``, ``gcs``,
  ``gcs_health``, ``raylet``, ``raylet_channel``, ``worker``,
  ``worker_pool``, ... (fnmatch patterns, ``*`` matches any).
- ``point``: where in the stack — ``send`` / ``recv`` (frame I/O),
  ``dispatch`` (server handler entry), ``spawn`` / ``teardown``
  (worker-pool process lifecycle), ``boot`` / ``exec`` (inside a
  worker process), ``rendezvous`` (collective-group rank-file I/O:
  ``collective.rendezvous.save_<tag>``/``load_<tag>`` with tag in
  ``ar``/``ag``/``bc``/``bar`` — ``drop`` makes a rank file vanish,
  ``kill`` dies mid-collective), ``checkpoint`` (the stateful
  recovery plane: ``actor.checkpoint.save`` fires in the executor
  mid-save with the generation staged but not yet renamed — ``kill``
  is the canonical torn-save crash, ``drop`` makes the save vanish;
  ``actor.checkpoint.restore`` fires per restore attempt — ``drop``
  fails that generation so restore falls back one; and
  ``actor.checkpoint.commit`` fires at the driver's commit site —
  ``drop`` withholds the COMMIT marker, leaving the generation torn),
  ``dcn`` (the cross-slice tier: ``multislice.dcn.save_<tag>`` fires
  before a leader's DCN rank-file write — ``drop`` makes it vanish so
  peers abort via the liveness plane, ``kill`` dies mid-DCN-collective
  — and ``multislice.dcn.load_<tag>`` fires per remote rank-file read
  — ``drop`` declares the transfer failed: the reader writes the DCN
  abort marker and raises typed instead of burning the timeout),
  ``provider`` (the autoscaler's cloud seam, fired through
  ``fire_site`` so the SITE applies every action:
  ``autoscaler.provider.launch`` — ``drop`` loses the launch request
  cloud-side (the instance never appears in ``describe``), ``delay``
  stretches the boot by the rule's seconds instead of stalling the
  reconciler — and ``autoscaler.provider.boot`` — ``kill`` makes the
  node boot and immediately die, the boot-then-die preemption
  analog, WITHOUT exiting the driver process hosting the provider),
  ``transfer`` (the object plane's pull engine:
  ``object.transfer.fetch`` fires in the PULLING process before each
  chunk RPC — ``drop`` discards the chunk attempt (a retry with
  backoff), ``sever`` cuts the peer connection mid-pull (a reconnect
  or re-route), ``delay`` stalls the chunk — and
  ``object.transfer.seal`` fires just before a completed pull seals
  into the local store — ``kill`` dies holding a full unsealed
  buffer, the restart-storm mid-transfer death; docs/object_plane.md).
- ``method``: the RPC method / push topic / task name at the event
  (``reply`` for reply frames; empty for lifecycle points).
- ``action``: ``drop`` (frame vanishes), ``delay=SECONDS`` (stall),
  ``dup`` (frame or dispatch happens twice), ``sever`` (the
  connection dies mid-flight), ``kill`` (the process exits
  ``KILL_EXIT_CODE`` at the event — the chaos analog of kill -9),
  ``pressure=FRACTION`` (inject a synthetic memory-usage reading at
  the raylet watchdog's ``sample`` point — OOM paths become
  deterministically testable without real memory exhaustion).
- ``@after``: fire on the Nth *matching* event (1-based, default 1);
  earlier matches count but pass through.
- ``xCount``: keep firing for this many consecutive matches
  (default 1; ``x*`` = every match from ``@after`` on).

Rules can carry a **phase** tag (``install_phase``): the soak plane's
chaos scheduler arms one phase's rule set at a phase boundary and
disarms it at the next, without disturbing rules outside the phase.
Both operations are a single atomic swap of the rule list under the
plane lock, so a concurrent ``fire()`` always observes either the
whole old rule set or the whole new one — never a half-installed
phase.

The plane can also mirror every fired event to a **JSONL fault-event
log** (``set_event_log``; child processes inherit it through
``RTPU_CHAOS_LOG``). The soak scheduler writes its arm/disarm
timeline into the same stream; see docs/soak.md for which record
kinds are digest-stable (the replay contract) and which are
informational.

Rules are matched first-hit-wins in install order. Matching and
trigger counting are fully deterministic; an optional ``%prob``
suffix makes a rule probabilistic, evaluated against the plane's
seeded RNG so a fixed seed reproduces the exact firing sequence.

Rules arrive three ways:

- programmatic: ``chaos.install("gcs_client.send.kv_put:sever")``
  (tests in the same process);
- environment: ``RTPU_CHAOS`` (child processes inherit it — raylet,
  GCS, and worker processes arm themselves at entry);
- config: the ``chaos_rules`` system-config knob, which travels to
  spawned raylet/GCS processes with the serialized config.

Hook sites call ``chaos.fire(component, point, method)``; with no
rules installed that is one predicate check, so the production hot
path stays effectively free.
"""

from __future__ import annotations

import fnmatch
import json
import logging
import os
import random
import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

logger = logging.getLogger(__name__)

ENV_VAR = "RTPU_CHAOS"
ENV_SEED_VAR = "RTPU_CHAOS_SEED"
ENV_LOG_VAR = "RTPU_CHAOS_LOG"

# Exit status of a chaos 'kill' — distinctive, so tests (and humans
# reading a raylet log) can tell an injected death from a real crash.
KILL_EXIT_CODE = 42

ACTIONS = ("drop", "delay", "dup", "sever", "kill", "pressure")
POINTS = ("send", "recv", "dispatch", "spawn", "teardown", "boot",
          "exec", "watchdog", "rendezvous", "checkpoint", "dcn",
          "map", "provider", "transfer", "*")

_RULE_RE = re.compile(
    r"^(?P<component>[^.:\s]+)\.(?P<point>[^.:\s]+)\.(?P<method>[^:\s]*)"
    r":(?P<action>[a-z]+)"
    r"(?:=(?P<arg>[0-9.]+))?"
    r"(?:@(?P<after>[0-9]+))?"
    r"(?:x(?P<count>[0-9]+|\*))?"
    r"(?:%(?P<prob>[0-9.]+))?$")


class ChaosRuleError(ValueError):
    """A rule string does not parse / names an unknown action."""


class ChaosRule:
    """One parsed injection rule plus its live trigger counters."""

    __slots__ = ("component", "point", "method", "action", "arg",
                 "after", "count", "prob", "matched", "fired", "phase")

    def __init__(self, component: str, point: str, method: str,
                 action: str, arg: float = 0.0, after: int = 1,
                 count: int = 1, prob: Optional[float] = None,
                 phase: Optional[str] = None):
        if action not in ACTIONS:
            raise ChaosRuleError(
                f"unknown chaos action {action!r} (one of {ACTIONS})")
        if after < 1:
            raise ChaosRuleError("@after is 1-based; got "
                                 f"{after}")
        self.component = component
        self.point = point
        self.method = method
        self.action = action
        self.arg = arg
        self.after = after
        self.count = count          # -1 = unlimited
        self.prob = prob
        self.phase = phase          # install_phase scope tag (or None)
        self.matched = 0            # events this rule pattern-matched
        self.fired = 0              # events it actually acted on

    @classmethod
    def parse(cls, text: str) -> "ChaosRule":
        m = _RULE_RE.match(text.strip())
        if m is None:
            raise ChaosRuleError(
                f"bad chaos rule {text!r}: expected "
                "component.point.method:action[=arg][@after][xN][%p]")
        count_s = m.group("count")
        return cls(
            component=m.group("component"),
            point=m.group("point"),
            method=m.group("method") or "*",
            action=m.group("action"),
            arg=float(m.group("arg") or 0.0),
            after=int(m.group("after") or 1),
            count=(-1 if count_s == "*" else int(count_s or 1)),
            prob=(float(m.group("prob"))
                  if m.group("prob") is not None else None))

    def matches(self, component: str, point: str, method: str) -> bool:
        return (fnmatch.fnmatchcase(component, self.component)
                and fnmatch.fnmatchcase(point, self.point)
                and fnmatch.fnmatchcase(method or "", self.method))

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"ChaosRule({self.component}.{self.point}.{self.method}"
                f":{self.action}@{self.after}x{self.count} "
                f"matched={self.matched} fired={self.fired})")


class ChaosPlane:
    """Rule store + event evaluator. One per process (module global);
    tests may build private planes for unit-testing the matcher."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        # The rule list is treated as IMMUTABLE: every mutation builds
        # a fresh list and swaps it in with one assignment under _lock,
        # so a concurrent fire() observes either the whole old set or
        # the whole new set — never a partially replaced one. (Rule
        # trigger counters still mutate in place; fire() holds _lock
        # for the whole match-and-count step.)
        self._rules: List[ChaosRule] = []  # guarded-by: _lock
        self._rng = random.Random(seed)
        # fired events, for assertions: (component, point, method, action)
        self.events: List[Tuple[str, str, str, str]] = []  # guarded-by: _lock
        self.armed = False
        self._event_log_path: Optional[str] = None
        self._event_log_lock = threading.Lock()
        self._event_log_fh = None

    @staticmethod
    def _parse_rules(rules: Union[str, Sequence],
                     phase: Optional[str] = None) -> List[ChaosRule]:
        parsed: List[ChaosRule] = []
        if isinstance(rules, str):
            rules = [r for r in rules.split(";") if r.strip()]
        for r in rules:
            rule = r if isinstance(r, ChaosRule) else ChaosRule.parse(r)
            if phase is not None:
                rule.phase = phase
            parsed.append(rule)
        return parsed

    def install(self, rules: Union[str, Sequence],
                seed: Optional[int] = None) -> None:
        """Add rules (a spec string with ``;``-separated rules, or a
        sequence of strings / ChaosRule objects). Arms the plane.
        The new rule set becomes visible to ``fire()`` atomically."""
        parsed = self._parse_rules(rules)
        with self._lock:
            if seed is not None:
                self._rng = random.Random(seed)
            self._rules = self._rules + parsed    # atomic swap
            self.armed = bool(self._rules)
        if parsed:
            logger.warning("chaos plane armed: %d rule(s) active",
                           len(parsed))

    def install_phase(self, phase: str, rules: Union[str, Sequence],
                      seed: Optional[int] = None) -> None:
        """Replace the rule set of one named phase in a single atomic
        swap: any previous rules tagged ``phase`` go away and the new
        ones appear in the same assignment, leaving rules outside the
        phase (and their trigger counters) untouched."""
        parsed = self._parse_rules(rules, phase=phase)
        with self._lock:
            if seed is not None:
                self._rng = random.Random(seed)
            kept = [r for r in self._rules if r.phase != phase]
            self._rules = kept + parsed           # atomic swap
            self.armed = bool(self._rules)
        logger.warning("chaos phase %r armed: %d rule(s)",
                       phase, len(parsed))

    def clear_phase(self, phase: str) -> int:
        """Atomically remove every rule tagged ``phase``; rules outside
        the phase keep running with their counters intact. Returns the
        number of rules removed."""
        with self._lock:
            kept = [r for r in self._rules if r.phase != phase]
            removed = len(self._rules) - len(kept)
            self._rules = kept                    # atomic swap
            self.armed = bool(self._rules)
        if removed:
            logger.warning("chaos phase %r disarmed: %d rule(s)",
                           phase, removed)
        return removed

    def clear(self) -> None:
        with self._lock:
            self._rules = []
            self.events.clear()
            self.armed = False

    def rules(self) -> List[ChaosRule]:
        with self._lock:
            return list(self._rules)

    # -- JSONL fault-event log -----------------------------------------

    def set_event_log(self, path: Optional[str]) -> None:
        """Mirror every fired event to ``path`` as one JSON line
        (append mode, flushed per record so a ``kill`` firing right
        after still leaves its record on disk). ``None`` detaches."""
        fh = open(path, "a", encoding="utf-8") if path else None
        with self._event_log_lock:
            old, self._event_log_fh = self._event_log_fh, fh
            self._event_log_path = path
        if old is not None:
            try:
                old.close()
            except OSError:  # pragma: no cover - best effort
                pass

    def log_event(self, record: Dict) -> None:
        """Append one JSON record to the fault-event log (no-op when
        no log is attached). Used by fire() for ``kind=fire`` records
        and by the soak scheduler for its arm/disarm timeline."""
        with self._event_log_lock:
            if self._event_log_fh is None:
                return
            try:
                self._event_log_fh.write(
                    json.dumps(record, sort_keys=True) + "\n")
                self._event_log_fh.flush()
            except OSError:  # pragma: no cover - log is best effort
                logger.debug("chaos event log write failed",
                             exc_info=True)

    def fire(self, component: str, point: str, method: str = ""
             ) -> Optional[str]:
        """Evaluate one event. Returns the action the HOOK SITE must
        apply (``drop`` / ``dup`` / ``sever``) or None to proceed
        normally; ``delay`` sleeps here and ``kill`` exits here."""
        return self.fire_arg(component, point, method)[0]

    def fire_arg(self, component: str, point: str, method: str = ""
                 ) -> Tuple[Optional[str], float]:
        """Like ``fire`` but returns ``(action, arg)`` for hook sites
        whose action carries a value — ``pressure`` injects ``arg`` as
        a synthetic memory-usage fraction into the raylet watchdog
        (``raylet.watchdog.sample*:pressure=0.97``; the watchdog's
        event method is ``sampleN`` with N = killable-candidate
        count, so ``sample2`` targets exactly-two-victims samples)."""
        action, arg = self._evaluate(component, point, method)
        if action is None:
            return None, 0.0
        if action == "delay":
            time.sleep(arg)
            return None, 0.0
        if action == "kill":
            logger.warning("chaos: kill at %s.%s.%s (pid %d)",
                           component, point, method, os.getpid())
            # os._exit, not sys.exit: the point is an abrupt death with
            # no cleanup, finally-blocks, or atexit — the kill -9 analog.
            os._exit(KILL_EXIT_CODE)
        logger.warning("chaos: %s at %s.%s.%s", action, component,
                       point, method)
        return action, arg

    def fire_site(self, component: str, point: str, method: str = ""
                  ) -> Tuple[Optional[str], float]:
        """Like ``fire_arg`` but the SITE applies every action: no
        inline sleep on ``delay`` and no process exit on ``kill`` —
        the provider seam simulates the faulted RESOURCE (a slow boot,
        a node that boots then dies) rather than faulting the control
        loop's own process."""
        action, arg = self._evaluate(component, point, method)
        if action is not None:
            logger.warning("chaos: %s at %s.%s.%s (site-applied)",
                           action, component, point, method)
        return action, arg

    def _evaluate(self, component: str, point: str, method: str
                  ) -> Tuple[Optional[str], float]:
        """Rule matching + event/log records, shared by the inline
        (``fire_arg``) and site-applied (``fire_site``) entries."""
        if not self.armed:
            return None, 0.0
        action = None
        arg = 0.0
        with self._lock:
            for rule in self._rules:
                if not rule.matches(component, point, method):
                    continue
                rule.matched += 1
                if rule.matched < rule.after:
                    continue
                if (rule.count >= 0
                        and rule.matched >= rule.after + rule.count):
                    continue
                if (rule.prob is not None
                        and self._rng.random() >= rule.prob):
                    continue
                rule.fired += 1
                action, arg = rule.action, rule.arg
                self.events.append((component, point, method, action))
                break
        if action is None:
            return None, 0.0
        # fire records are informational (timing-dependent, excluded
        # from the soak replay digest); written before kill so the
        # record survives the process.
        self.log_event({"kind": "fire", "component": component,
                        "point": point, "method": method,
                        "action": action, "pid": os.getpid()})
        return action, arg


_plane = ChaosPlane()


def get_plane() -> ChaosPlane:
    return _plane


def active() -> bool:
    return _plane.armed


def fire(component: str, point: str, method: str = "") -> Optional[str]:
    """Module-level hook entry: cheap no-op while unarmed."""
    if not _plane.armed:
        return None
    return _plane.fire(component, point, method)


def fire_arg(component: str, point: str, method: str = ""
             ) -> Tuple[Optional[str], float]:
    """(action, arg) hook entry for value-carrying actions
    (``pressure``); cheap no-op while unarmed."""
    if not _plane.armed:
        return None, 0.0
    return _plane.fire_arg(component, point, method)


def fire_site(component: str, point: str, method: str = ""
              ) -> Tuple[Optional[str], float]:
    """(action, arg) hook entry whose SITE applies every action (no
    inline delay sleep / kill exit — see ChaosPlane.fire_site); cheap
    no-op while unarmed."""
    if not _plane.armed:
        return None, 0.0
    return _plane.fire_site(component, point, method)


def install(rules: Union[str, Sequence], seed: Optional[int] = None
            ) -> None:
    _plane.install(rules, seed=seed)


def install_phase(phase: str, rules: Union[str, Sequence],
                  seed: Optional[int] = None) -> None:
    _plane.install_phase(phase, rules, seed=seed)


def clear_phase(phase: str) -> int:
    return _plane.clear_phase(phase)


def set_event_log(path: Optional[str]) -> None:
    _plane.set_event_log(path)


def log_event(record: Dict) -> None:
    _plane.log_event(record)


def clear() -> None:
    _plane.clear()


def events() -> List[Tuple[str, str, str, str]]:
    with _plane._lock:
        return list(_plane.events)


def maybe_arm() -> None:
    """Arm from the environment (RTPU_CHAOS) or the ``chaos_rules``
    config knob. Called at every process entrypoint (driver init,
    raylet/GCS main, worker_main); idempotent when nothing is set.
    The env var wins — it is how tests scope rules to one child."""
    log_path = os.environ.get(ENV_LOG_VAR, "")
    if log_path and _plane._event_log_path is None:
        try:
            _plane.set_event_log(log_path)
        except OSError:  # pragma: no cover - log is best effort
            logger.debug("chaos event log unavailable", exc_info=True)
    if _plane.armed:
        return
    spec = os.environ.get(ENV_VAR, "")
    seed_s = os.environ.get(ENV_SEED_VAR, "")
    if not spec:
        try:
            from ray_tpu_torch._private.config import get_config
            spec = get_config().chaos_rules
            if not seed_s:
                seed_s = str(get_config().chaos_seed)
        except Exception:
            logger.debug("chaos config unavailable", exc_info=True)
            spec = ""
    if spec:
        _plane.install(spec, seed=int(seed_s) if seed_s else 0)
