"""Worker pool: process workers for CPU tasks, in-process threads for
GPU tasks.

Reference analog: ``src/ray/raylet/worker_pool.{h,cc}`` [UNVERIFIED —
mount empty, SURVEY.md §0] — process leasing, prestart, dedicated
workers for actors.

Device-first split (see worker_process.py docstring): exactly one
process per host owns the cards (the driver), so anything demanding
``GPU`` resources executes on an in-process thread worker; pure-host
tasks lease ``exec``'d subprocesses that register back over the node's
hub socket (the raylet pattern — no multiprocessing inheritance, no
__main__ re-import, no CUDA state leaking into children, which run with
``CUDA_VISIBLE_DEVICES`` empty).
"""

from __future__ import annotations

import os
import queue
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.connection_hub import ConnectionHub
from ray_tpu_torch._private.ids import WorkerID
from ray_tpu_torch._private.worker_process import ExecutionEnv


class BaseWorker:
    def __init__(self):
        self.worker_id = WorkerID.from_random()
        self.known_functions: set = set()
        self.leased = False
        self.is_actor_worker = False
        self.alive = True
        self.ready = False
        self.last_idle = time.monotonic()
        # Normal tasks queued on this worker's pipe (lease pipelining):
        # the worker returns to the idle pool only at zero. ``pipeq``
        # is their send order (head = executing); ``last_activity``
        # and ``steal_pending`` drive the stalled-pipeline rescue.
        self.inflight = 0
        # unbounded-ok: dispatch never queues past PIPELINE_DEPTH
        # (pipeline_candidate refuses workers at the cap)
        self.pipeq: "deque" = deque()
        self.last_activity = time.monotonic()
        self.steal_pending = False
        # ids the in-flight rescue steal asked for: steal_pending is
        # cleared only by a reply covering these (an unsolicited
        # late-drop stolen reply must not unlatch an in-flight rescue)
        self.rescue_steal_ids: set = set()
        # targeted cancel steals in flight (task_id -> force): when the
        # stolen reply omits one, the owner falls through to the
        # interrupt path instead of trusting the miss (steal/exec race)
        self.cancel_steal_targets: dict = {}
        # function_id -> template name already shipped to this worker
        # (the exec-payload template strip; see node_manager._send_task)
        self.exec_templates: dict = {}

    def send(self, msg: tuple) -> None:
        raise NotImplementedError

    def kill(self) -> None:
        raise NotImplementedError


class ProcessWorker(BaseWorker):
    """An exec'd subprocess; replies arrive on ``conn`` (set once the
    child registers at the hub) and are routed by the node IO thread."""

    kind = "process"

    def __init__(self, session: str, max_inline_bytes: int,
                 hub: ConnectionHub,
                 on_ready: Callable[["ProcessWorker"], None],
                 python_exe: Optional[str] = None,
                 env_tag: Optional[str] = None):
        super().__init__()
        from ray_tpu_torch._private import chaos
        chaos.fire("worker_pool", "spawn")
        self.conn = None
        self._on_ready = on_ready
        # pip runtime env: exec the venv's interpreter; the pool keeps
        # such workers in a per-tag idle list for reuse.
        self.env_tag = env_tag
        token = self.worker_id.hex()
        hub.expect(token, self._register)
        env = dict(os.environ)
        # Children never own a card: the driver does. Any torch they
        # import sees no CUDA device and runs on the CPU.
        env["CUDA_VISIBLE_DEVICES"] = ""
        env["RAY_TPU_WORKER_MODE"] = "1"
        env["PYTHONUNBUFFERED"] = "1"   # timely stdout capture to logs
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))]
            + env.get("PYTHONPATH", "").split(os.pathsep))
        entry = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "worker_entry.py")
        # Per-worker stdout/stderr capture (reference: worker logs under
        # /tmp/ray/session_*/logs): the node's log monitor / read_logs
        # RPC tails these files to the driver.
        from ray_tpu_torch._private.log_monitor import worker_log_path
        self.log_path = worker_log_path(session, self.worker_id.hex())
        # non-durable-ok: append-only worker log stream; a torn tail
        # line costs log text, never state
        log = open(self.log_path, "ab", buffering=0)
        try:
            self.proc = subprocess.Popen(
                [python_exe or sys.executable, entry,
                 "--address", hub.address, "--token", token,
                 "--session", session, "--max-inline",
                 str(max_inline_bytes)],
                env=env, start_new_session=True, stdout=log, stderr=log)
        finally:
            log.close()
        self.start_time = time.monotonic()

    def _register(self, conn, pid: int) -> None:
        self.conn = conn
        self.ready = True
        self._on_ready(self)

    def send(self, msg: tuple) -> None:
        if self.conn is None:
            raise RuntimeError("worker not registered yet")
        self.conn.send(msg)

    def kill(self) -> None:
        from ray_tpu_torch._private import chaos
        chaos.fire("worker_pool", "teardown")
        self.alive = False
        try:
            self.proc.terminate()
        except Exception:
            pass    # process already exited
        if self.conn is not None:
            try:
                self.conn.close()
            except Exception:
                pass    # pipe already closed by the IO thread


class InProcessWorker(BaseWorker):
    """A thread in the host process (GPU-capable). Executes the same
    payloads as a process worker; replies go to ``reply_handler``."""

    kind = "in_process"

    def __init__(self, session: str, max_inline_bytes: int,
                 reply_handler: Callable[["InProcessWorker", tuple], None]):
        super().__init__()
        self.env = ExecutionEnv(session, max_inline_bytes,
                                in_process=True)
        # unbounded-ok: fed by the dispatcher one leased task at a
        # time (plus control messages); a bound here could deadlock
        # the shutdown path
        self._queue: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._reply = reply_handler
        self.ready = True
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"rtpu-inproc-{self.worker_id.hex()[:6]}")
        self._thread.start()

    def _loop(self):
        # Execution routing (thread pools for max_concurrency>1 sync
        # actors — CUDA launches release the GIL while the device
        # computes, so threads overlap device work — and per-actor
        # event loops for async actors) lives in ExecutionEnv.dispatch,
        # shared with process workers.
        def send(reply):
            self._reply(self, reply)

        while True:
            msg = self._queue.get()
            if msg is None:
                self.env.shutdown_exec()
                return
            op = msg[0]
            if op == "func":
                self.env.cache_function(msg[1], msg[2])
            elif op == "dag_stage":
                self.env.dag_stages[msg[1]] = msg[2]
            elif op == "actor_tmpl":
                self.env.actor_templates[msg[1]] = msg[2]
            elif op == "exec_tmpl":
                self.env.exec_templates[msg[1]] = msg[2]
            elif op == "cancel_actor_task":
                self.env.cancel_actor_task(msg[1], msg[2])
            elif op == "ckpt_save":
                # save-NOW (autoscaler drain) — see worker_process
                try:
                    self.env.save_actor_checkpoint(msg[1], send)
                except Exception:
                    pass    # non-checkpointable actor: owner poll
                            # times out and the restart path migrates
            elif op in ("exec", "create_actor", "exec_actor",
                        "exec_actor_batch"):
                try:
                    self.env.dispatch(op, msg[1], send)
                finally:
                    # The process-level identity fallback is shared
                    # with the DRIVER (in-process workers live in its
                    # process): any id left behind makes the driver
                    # thread's get_runtime_context() misreport worker
                    # mode. Clear after every synchronously executed
                    # op — unlike process workers, untagged user
                    # threads outliving an in-process task lose the
                    # fallback identity, a cost worth the correct
                    # driver context.
                    from ray_tpu_torch._private.worker_process import (
                        _TASK_FALLBACK)
                    _TASK_FALLBACK["task_id"] = b""
                    _TASK_FALLBACK["actor_id"] = b""

    def send(self, msg: tuple) -> None:
        if msg[0] == "shutdown":
            self._queue.put(None)
            return
        self._queue.put(msg)

    def kill(self) -> None:
        # Threads can't be force-killed; mark dead and drain.
        self.alive = False
        self._queue.put(None)


class WorkerPool:
    """Leases workers per resource demand; dedicated leases for actors."""

    def __init__(self, session: str, hub: ConnectionHub,
                 reply_handler: Callable[[BaseWorker, tuple], None],
                 on_worker_ready: Callable[[], None],
                 max_process_workers: int = 8,
                 max_inproc_workers: int = 16):
        cfg = get_config()
        self._session = session
        self._hub = hub
        self._max_inline = cfg.max_direct_call_object_size
        self._reply_handler = reply_handler
        self._on_worker_ready = on_worker_ready
        self._max_process = max_process_workers
        self._max_inproc = max_inproc_workers
        self._idle_process: List[ProcessWorker] = []  # guarded-by: _lock
        # pip-runtime-env workers, idle, keyed by env tag (venv hash)
        self._idle_tagged: Dict[str, List[ProcessWorker]] = {}  # guarded-by: _lock
        self._idle_inproc: List[InProcessWorker] = []  # guarded-by: _lock
        self._all: Dict[WorkerID, BaseWorker] = {}  # guarded-by: _lock
        self._lock = threading.RLock()

    # -- substrate choice --------------------------------------------------

    @staticmethod
    def substrate_for(resources: Dict[str, float]) -> str:
        return "in_process" if resources.get("GPU", 0) > 0 else "process"

    # -- leasing -----------------------------------------------------------

    def pop_worker(self, resources: Dict[str, float],
                   dedicated: bool = False,
                   env_tag: Optional[str] = None,
                   python_exe: Optional[str] = None
                   ) -> Optional[BaseWorker]:
        """Returns a leased worker, or None (caller re-queues; a newly
        spawned worker will wake the dispatcher when it registers).
        ``env_tag``/``python_exe`` lease a pip-runtime-env worker: a
        process exec'd with the env's interpreter, reused only for the
        same tag."""
        substrate = self.substrate_for(resources)
        with self._lock:
            self._reap_dead()
            if env_tag is not None:
                idle = self._idle_tagged.setdefault(env_tag, [])
            else:
                idle = (self._idle_inproc if substrate == "in_process"
                        else self._idle_process)
            while idle:
                w = idle.pop()
                if w.alive:
                    w.leased = True
                    w.is_actor_worker = dedicated
                    return w
            # Dedicated (actor) workers sit outside the pool cap: actors
            # are bounded by their resource reservations, the cap only
            # governs the reusable task pool (otherwise a couple of
            # actors would starve task dispatch — reference semantics:
            # dedicated workers are not pool members).
            count = sum(1 for w in self._all.values()
                        if w.alive and w.kind == substrate
                        and not w.is_actor_worker)
            limit = (self._max_inproc if substrate == "in_process"
                     else self._max_process)
            if count >= limit:
                if substrate != "process" or \
                        not self._evict_idle_mismatch(env_tag):
                    return None
                # an idle worker of another env was evicted: spawn ours
            if substrate == "in_process":
                w = InProcessWorker(self._session, self._max_inline,
                                    self._reply_handler)
                self._all[w.worker_id] = w
                w.leased = True
                w.is_actor_worker = dedicated
                return w
            # Process workers register asynchronously; spawn and let the
            # dispatcher retry when the hub calls back.
            pw = ProcessWorker(self._session, self._max_inline, self._hub,
                               self._worker_registered,
                               python_exe=python_exe, env_tag=env_tag)
            self._all[pw.worker_id] = pw
            return None

    # lock-held: _lock
    def _evict_idle_mismatch(self, want_tag: Optional[str]) -> bool:
        """At the process cap, kill ONE idle worker whose env doesn't
        match the requested lease so the cap can admit the right kind
        (otherwise a pip-env request head-of-line blocks behind idle
        plain workers, and vice versa). Lock held. Returns True if a
        slot was freed."""
        candidates = []
        for tag, tagged in self._idle_tagged.items():
            if tag != want_tag:
                candidates.extend(tagged)
        if want_tag is not None:
            candidates.extend(self._idle_process)
        if not candidates:
            return False
        victim = min(candidates, key=lambda w: w.last_idle)
        for pool in ([self._idle_process]
                     + list(self._idle_tagged.values())):
            if victim in pool:
                pool.remove(victim)
        self._all.pop(victim.worker_id, None)
        try:
            victim.send(("shutdown",))
        except Exception:
            pass    # broken pipe: the kill below still lands
        victim.kill()
        return True

    def _worker_registered(self, worker: ProcessWorker) -> None:
        with self._lock:
            if worker.alive:
                if worker.env_tag is not None:
                    self._idle_tagged.setdefault(worker.env_tag,
                                                 []).append(worker)
                else:
                    self._idle_process.append(worker)
        self._on_worker_ready()

    _REAP_PERIOD_S = 0.1

    def _reap_dead(self) -> None:  # lock-held: _lock
        cfg = get_config()
        now = time.monotonic()
        # Throttled: this runs on every lease attempt (per task at
        # wave rates) but reaps on a ~100ms cadence; pop_worker's own
        # alive checks already skip dead workers in between.
        if now - getattr(self, "_last_reap", 0.0) < self._REAP_PERIOD_S:
            return
        self._last_reap = now
        for w in list(self._all.values()):
            if isinstance(w, ProcessWorker) and not w.ready:
                if w.proc.poll() is not None or \
                        now - w.start_time > cfg.worker_start_timeout_s:
                    w.alive = False
                    self._all.pop(w.worker_id, None)
        # Reap process workers idle beyond worker_pool_max_idle_s,
        # always keeping one warm (reference: idle worker killing).
        max_idle = cfg.worker_pool_max_idle_s
        while len(self._idle_process) > 1:
            oldest = min(self._idle_process, key=lambda w: w.last_idle)
            if now - oldest.last_idle <= max_idle:
                break
            self._idle_process.remove(oldest)
            self._all.pop(oldest.worker_id, None)
            try:
                oldest.send(("shutdown",))
            except Exception:
                pass    # broken pipe: the kill below still lands
            oldest.kill()
        # pip-env workers: reap ALL past the idle deadline (no warm
        # keeper — they still count against the process cap, so idle
        # tagged workers from many distinct envs would exhaust it).
        for tag, tagged in list(self._idle_tagged.items()):
            for w in [w for w in tagged
                      if now - w.last_idle > max_idle]:
                tagged.remove(w)
                self._all.pop(w.worker_id, None)
                try:
                    w.send(("shutdown",))
                except Exception:
                    pass    # broken pipe: the kill below still lands
                w.kill()
            if not tagged:
                del self._idle_tagged[tag]

    # Max queued normal tasks per leased worker. Sized with the
    # data-plane batching in mind: the dispatch flush coalesces up to
    # this many exec payloads into one pipe frame, and the worker's
    # reply coalescer mirrors it on the way back; stalled pipes still
    # rescue via the steal path, so depth costs latency only when the
    # head task blocks — and then the rescue empties the pipe anyway.
    PIPELINE_DEPTH = 32

    def pipeline_candidate(self) -> Optional[BaseWorker]:
        """A busy generic process worker with pipe headroom: normal
        tasks can queue on its connection instead of waiting a full
        done→push→pop round trip for a pool slot (reference:
        NormalTaskSubmitter's lease pipelining). Returns the
        least-loaded candidate, or None."""
        best = None
        best_infl = self.PIPELINE_DEPTH
        with self._lock:
            for w in self._all.values():
                if (w.alive and w.ready and w.leased
                        and w.kind == "process"
                        and not w.is_actor_worker
                        and getattr(w, "env_tag", None) is None
                        and 0 < w.inflight < best_infl):
                    best, best_infl = w, w.inflight
        return best

    def push_worker(self, worker: BaseWorker) -> None:
        with self._lock:
            if not worker.alive:
                self._all.pop(worker.worker_id, None)
                return
            worker.leased = False
            worker.is_actor_worker = False
            worker.last_idle = time.monotonic()
            if worker.kind == "in_process":
                self._idle_inproc.append(worker)
            elif getattr(worker, "env_tag", None) is not None:
                self._idle_tagged.setdefault(worker.env_tag,
                                             []).append(worker)
            else:
                self._idle_process.append(worker)
        self._on_worker_ready()

    def remove_worker(self, worker: BaseWorker) -> None:
        with self._lock:
            worker.alive = False
            self._all.pop(worker.worker_id, None)
            if worker in self._idle_process:
                self._idle_process.remove(worker)
            for tagged in self._idle_tagged.values():
                if worker in tagged:
                    tagged.remove(worker)

    # -- io ----------------------------------------------------------------

    def process_connections(self) -> List:
        with self._lock:
            return [w.conn for w in self._all.values()
                    if isinstance(w, ProcessWorker) and w.alive
                    and w.conn is not None]

    def worker_by_conn(self, conn) -> Optional[ProcessWorker]:
        with self._lock:
            for w in self._all.values():
                if isinstance(w, ProcessWorker) and w.conn is conn:
                    return w
        return None

    def ensure_function(self, worker: BaseWorker, function_id: bytes,
                        blob_provider: Callable[[], bytes]) -> None:
        if function_id not in worker.known_functions:
            worker.send(("func", function_id, blob_provider()))
            worker.known_functions.add(function_id)

    def prestart(self, n: int) -> None:
        with self._lock:
            existing = sum(1 for w in self._all.values()
                           if w.alive and w.kind == "process")
            for _ in range(max(0, min(n, self._max_process) - existing)):
                pw = ProcessWorker(self._session, self._max_inline,
                                   self._hub, self._worker_registered)
                self._all[pw.worker_id] = pw

    def shutdown(self) -> None:
        with self._lock:
            workers = list(self._all.values())
            self._all.clear()
            self._idle_process.clear()
            self._idle_inproc.clear()
            self._idle_tagged.clear()
        graceful = []
        for w in workers:
            if isinstance(w, ProcessWorker) and w.conn is None:
                # Never registered (still booting): the shutdown message
                # has no channel to ride — kill outright instead of
                # waiting out the grace period for a worker that never
                # had work.
                w.kill()
                continue
            try:
                w.send(("shutdown",))
                graceful.append(w)
            except Exception:
                w.kill()
        deadline = time.monotonic() + 2.0
        for w in graceful:
            if isinstance(w, ProcessWorker):
                try:
                    w.proc.wait(max(0.05, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    w.kill()

    def stats(self) -> dict:
        with self._lock:
            return {
                "total": len(self._all),
                "idle_process": len(self._idle_process),
                "idle_in_process": len(self._idle_inproc),
            }
