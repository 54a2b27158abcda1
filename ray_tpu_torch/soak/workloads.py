"""The soak's mixed workload: three concurrently running drivers.

- :class:`IngressDriver` — open-loop HTTP traffic over a keep-alive
  connection against a batched+multiplexed serve deployment, with
  every Nth request an SSE stream. Open loop on purpose: requests
  are pipelined down the wire on a send-side clock, and a reader
  thread consumes responses in request order (the ingress pipelining
  contract), so arrival rate never adapts to service rate.
- :class:`TrainerDriver` — a 2-slice checkpointing
  ``MultiSliceTrainer`` fed per-epoch by a backpressured
  ``ray_tpu_torch.data`` pipeline; per-epoch analytic-sum verification is
  the exactly-once proof. Trainer-scope chaos rules are injected at
  epoch boundaries, symmetrically on every rank (the checkpoint
  plane aligns generations by call count).
- :class:`ChurnDriver` — a background normal-task/actor churn lane on
  the remote node: every task carries an idempotency token whose side
  effect (an exclusive-create ledger file) is idempotent by
  construction, so kills at exec entry, wire dup/drop faults, and OOM
  kills all leave exactly one applied effect per token. The lane also
  claims chaos arm-files (one worker installs the rule in its own
  process — the deterministic self-arm idiom).

Every driver classifies each unit of work into exactly one of
``ok`` / ``typed`` (a documented taxonomy error surfaced properly) /
``lost`` (hung, truncated without a terminal record, or wrong
value). The oracle's "no lost results" invariant is
``lost == 0`` across all three.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import re
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch._private import chaos

# HTTP statuses that may legitimately carry a typed taxonomy error
_TYPED_STATUSES = (500, 502, 503, 504)


# ---------------------------------------------------------------------------
# serve deployments (defined lazily: ray_tpu_torch.serve pulls the serve
# plane in; the soak builds them after the cluster is up)


def build_serve_apps(max_queued_requests: int = 512):
    """Deploy the batched+multiplexed echo deployment and the SSE
    stream generator; returns their names."""
    from ray_tpu_torch import serve

    @serve.deployment(num_replicas=2,
                      max_queued_requests=max_queued_requests,
                      ray_actor_options={"num_cpus": 0.25})
    class SoakEcho:
        """Echo with dynamic batching + model multiplexing: each item
        names a model id, the replica loads it through the multiplexed
        LRU, the reply proves which item and model it saw."""

        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            return model_id

        @serve.batch(max_batch_size=8, batch_wait_timeout_ms=5)
        async def __call__(self, items):
            out = []
            for it in items:
                out.append({"i": it["i"],
                            "model": self.get_model(it["model"]),
                            "pid": os.getpid()})
            return out

        def pid(self):
            return os.getpid()

        def chaos_arm(self, rule):
            chaos.install_phase("soak-serve", rule)
            return os.getpid()

        def chaos_disarm(self):
            chaos.clear_phase("soak-serve")
            return True

    @serve.deployment(num_replicas=1,
                      ray_actor_options={"num_cpus": 0.25})
    class SoakStream:
        """n-item stream; the ingress frames it as SSE when the
        client sends ``Accept: text/event-stream``."""

        def __call__(self, n):
            for i in range(int(n)):
                yield {"i": i}

        def pid(self):
            return os.getpid()

        def chaos_arm(self, rule):
            chaos.install_phase("soak-serve", rule)
            return os.getpid()

        def chaos_disarm(self):
            chaos.clear_phase("soak-serve")
            return True

    serve.run(SoakEcho.bind(), name="SoakEcho")
    serve.run(SoakStream.bind(), name="SoakStream")
    return ["SoakEcho", "SoakStream"]


def serve_chaos_arm(deployment: str, rule: str) -> Optional[int]:
    """Install ``rule`` inside ONE live replica of ``deployment`` via
    a direct per-replica call (the router would load-balance)."""
    from ray_tpu_torch import serve
    dep = serve._controller._deployments.get(deployment)
    if dep is None or not dep.replicas:
        return None
    handle = dep.replicas[0]
    return ray_tpu_torch.get(
        handle.handle_request.remote("chaos_arm", (rule,), {}, None),
        timeout=30)


def serve_chaos_disarm(deployment: str) -> None:
    """Best-effort phase disarm on every live replica (a replica the
    rule already killed is gone — its respawn carries no rules)."""
    from ray_tpu_torch import serve
    dep = serve._controller._deployments.get(deployment)
    if dep is None:
        return
    for handle in list(dep.replicas):
        try:
            ray_tpu_torch.get(handle.handle_request.remote(
                "chaos_disarm", (), {}, None), timeout=10)
        except Exception:
            pass    # dead replica: nothing to disarm


# ---------------------------------------------------------------------------
# ingress driver


class _Pending:
    __slots__ = ("kind", "i", "model", "n", "t0")

    def __init__(self, kind, i=0, model="", n=0):
        self.kind = kind        # "unary" | "stream"
        self.i = i
        self.model = model
        self.n = n
        self.t0 = time.monotonic()


class IngressDriver:
    """Open-loop HTTP load: a sender thread pipelines requests down
    one keep-alive connection on a fixed clock; a reader thread
    consumes responses strictly in request order."""

    def __init__(self, period_s: float = 0.03, stream_every: int = 10,
                 stream_items: int = 4, max_inflight: int = 64):
        self.period_s = period_s
        self.stream_every = stream_every
        self.stream_items = stream_items
        self.max_inflight = max_inflight
        self.ok = 0
        self.typed = 0
        self.stream_ok = 0
        self.stream_typed = 0
        self.lost: List[str] = []
        self.latencies_calm: List[float] = []
        self.latencies_chaos: List[float] = []
        self.calm = True
        self._seq = 0
        self._pending: "collections.deque[_Pending]" = collections.deque()
        self._cv = threading.Condition()
        self._stop = False
        self._paused = False
        self._sock: Optional[socket.socket] = None
        self._rfile = None
        self._threads: List[threading.Thread] = []

    # -- lifecycle ----------------------------------------------------

    def start(self) -> "IngressDriver":
        self._connect()
        for fn in (self._send_loop, self._read_loop):
            t = threading.Thread(target=fn, daemon=True,
                                 name=f"soak-ingress-{fn.__name__}")
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=30)
        self._close()

    def pause(self, timeout: float = 30.0) -> bool:
        """Stop sending and wait for in-flight responses to drain
        (the settle windows measure a quiet serve plane)."""
        with self._cv:
            self._paused = True
            deadline = time.monotonic() + timeout
            while self._pending and not self._stop:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(left)
        return True

    def resume(self) -> None:
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    # -- wire ---------------------------------------------------------

    def _connect(self) -> None:
        from ray_tpu_torch import serve
        host, port = serve.http_address()
        s = socket.create_connection((host, port), timeout=60)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s
        self._rfile = s.makefile("rb")

    def _close(self) -> None:
        for obj in (self._rfile, self._sock):
            try:
                if obj is not None:
                    obj.close()
            except OSError:
                pass
        self._rfile = None
        self._sock = None

    @staticmethod
    def _http(name: str, payload, stream: bool, sse: bool) -> bytes:
        body = json.dumps(payload).encode()
        lines = [
            f"POST /{name}{'?stream=1' if stream else ''} HTTP/1.1",
            "Host: soak", "Content-Type: application/json",
            f"Content-Length: {len(body)}"]
        if sse:
            lines.append("Accept: text/event-stream")
        return ("\r\n".join(lines) + "\r\n\r\n").encode() + body

    def _send_loop(self) -> None:
        while True:
            with self._cv:
                while not self._stop and (
                        self._paused
                        or len(self._pending) >= self.max_inflight):
                    self._cv.wait(0.25)
                if self._stop:
                    return
                self._seq += 1
                seq = self._seq
                if seq % self.stream_every == 0:
                    p = _Pending("stream", n=self.stream_items)
                    raw = self._http("SoakStream", p.n, stream=False,
                                     sse=True)
                else:
                    p = _Pending("unary", i=seq,
                                 model=f"m{seq % 4}")
                    raw = self._http(
                        "SoakEcho", {"i": p.i, "model": p.model},
                        stream=False, sse=False)
                self._pending.append(p)
            try:
                self._sock.sendall(raw)
            except OSError as e:
                self._record_transport_loss(f"send failed: {e!r}")
            time.sleep(self.period_s)

    # -- reader -------------------------------------------------------

    def _read_head(self) -> Tuple[int, Dict[str, str]]:
        f = self._rfile
        line = f.readline()
        if not line:
            raise OSError("connection closed before response head")
        status = int(line.split()[1])
        headers: Dict[str, str] = {}
        while True:
            ln = f.readline().strip()
            if not ln:
                break
            k, _, v = ln.partition(b":")
            headers[k.strip().lower().decode()] = v.strip().decode()
        return status, headers

    def _iter_chunks(self):
        f = self._rfile
        while True:
            size_line = f.readline()
            if not size_line:
                raise OSError("connection closed mid-chunk-stream")
            size = int(size_line.strip(), 16)
            if size == 0:
                f.readline()
                return
            yield f.read(size)
            f.readline()        # chunk trailer CRLF

    def _read_body(self, headers: Dict[str, str]) -> bytes:
        if headers.get("transfer-encoding") == "chunked":
            return b"".join(self._iter_chunks())
        clen = int(headers.get("content-length", 0))
        return self._rfile.read(clen)

    def _read_loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait(0.25)
                if not self._pending and self._stop:
                    return
                p = self._pending[0]
            try:
                if p.kind == "unary":
                    self._consume_unary(p)
                else:
                    self._consume_stream(p)
            except OSError as e:
                self._record_transport_loss(f"read failed: {e!r}")
                continue
            with self._cv:
                if self._pending and self._pending[0] is p:
                    self._pending.popleft()
                self._cv.notify_all()

    def _consume_unary(self, p: _Pending) -> None:
        status, headers = self._read_head()
        body = self._read_body(headers)
        took = time.monotonic() - p.t0
        if status == 200:
            try:
                rec = json.loads(body)
            except ValueError:
                self.lost.append(f"unary {p.i}: unparseable 200 body")
                return
            if rec.get("i") == p.i and rec.get("model") == p.model:
                self.ok += 1
                (self.latencies_calm if self.calm
                 else self.latencies_chaos).append(took)
            else:
                self.lost.append(
                    f"unary {p.i}: wrong echo {rec!r}")
        elif status in _TYPED_STATUSES and "x-rtpu-error-type" in headers:
            self.typed += 1
        else:
            self.lost.append(f"unary {p.i}: untyped status {status}")

    def _consume_stream(self, p: _Pending) -> None:
        status, headers = self._read_head()
        if status != 200:
            body = self._read_body(headers)
            if status in _TYPED_STATUSES and "x-rtpu-error-type" in headers:
                self.stream_typed += 1
            else:
                self.lost.append(
                    f"stream: untyped status {status} {body[:80]!r}")
            return
        want = 0
        terminal: Optional[Dict] = None
        complete = False
        errored = False
        for blob in self._iter_chunks():
            if blob.startswith(b"event: error"):
                errored = True
                terminal = json.loads(blob.split(b"data: ", 1)[1])
                break
            if not blob.startswith(b"data: "):
                self.lost.append(f"stream: non-SSE frame {blob[:60]!r}")
                return
            rec = json.loads(blob.split(b"data: ", 1)[1])
            if rec.get("terminal"):
                errored = True
                terminal = rec
                break
            if rec.get("i") != want:
                self.lost.append(
                    f"stream: item {rec!r}, wanted i={want}")
                return
            want += 1
            if want == p.n:
                complete = True
        if errored:
            # an errored SSE stream's connection is closed by the
            # ingress — everything pipelined behind it is gone too
            if terminal and terminal.get("error_type"):
                self.stream_typed += 1
                self._reset_after_stream_error()
            else:
                self.lost.append(
                    f"stream: terminal without a type: {terminal!r}")
        elif complete:
            self.stream_ok += 1
            (self.latencies_calm if self.calm
             else self.latencies_chaos).append(
                time.monotonic() - p.t0)
        else:
            self.lost.append(
                f"stream: ended early at item {want}/{p.n}")

    def _reset_after_stream_error(self) -> None:
        """The ingress closes an errored stream's connection; the
        pipelined requests behind it never get responses. They were
        accepted-but-unanswerable at the transport level — requeue
        nothing, count nothing lost, reconnect and move on."""
        with self._cv:
            self._pending.clear()
            self._cv.notify_all()
        self._close()
        try:
            self._connect()
        except OSError as e:
            self.lost.append(f"reconnect failed: {e!r}")

    def _record_transport_loss(self, why: str) -> None:
        with self._cv:
            n = len(self._pending)
            self._pending.clear()
            self._cv.notify_all()
        if n:
            self.lost.append(f"{why} with {n} in flight")
        self._close()
        try:
            self._connect()
        except OSError as e:
            self.lost.append(f"reconnect failed: {e!r}")

    def stats(self) -> Dict[str, float]:
        return {"ingress_ok": self.ok, "ingress_typed": self.typed,
                "stream_ok": self.stream_ok,
                "stream_typed": self.stream_typed,
                "ingress_lost": len(self.lost)}


# ---------------------------------------------------------------------------
# trainer driver


class TrainerDriver(threading.Thread):
    """Epoch loop around a 2-slice checkpointing trainer fed by a
    fresh ``ray_tpu_torch.data`` pipeline each epoch. Chaos rules arrive
    through :meth:`inject` and are armed at the NEXT epoch boundary —
    symmetrically on every rank (real rule on the victim, an ``@999``
    placeholder on peers) — then disarmed on every rank after the
    epoch. Never mid-epoch: checkpoint generations align by call
    count, and an asymmetric call would wedge two-phase commit."""

    EPOCH_N = 48
    EPOCH_BLOCKS = 6

    def __init__(self):
        super().__init__(daemon=True, name="soak-trainer")
        self.trainer = None
        self.epochs_ok = 0
        self.numerics_ok = True
        self.failures: List[str] = []
        self.recovered: List[str] = []      # typed, remediated epochs
        self._expect_steps = 0
        self._expect_state = 0.0
        self._halt = threading.Event()
        self._rules: "queue.Queue[Tuple[Tuple[str, ...], threading.Event]]" \
            = queue.Queue()

    @staticmethod
    def _build():
        from ray_tpu_torch.train.multislice import (MultiSliceConfig,
                                              MultiSliceTrainer)

        def init_fn():
            return np.zeros((1,), dtype=np.float64)

        def grad_fn(state, rank, world, step, batch):
            return np.asarray([float(np.sum(batch["x"]))])

        def apply_fn(state, synced):
            new = state + synced
            return new, float(new[0])

        # backstop timeouts only: faults abort typed in milliseconds
        # via the liveness plane, so generous values cost nothing on
        # real failures and keep a loaded box from spurious recovers
        return MultiSliceTrainer(
            init_fn, grad_fn, apply_fn,
            MultiSliceConfig(num_slices=2, ranks_per_slice=1,
                             gang_max_restarts=16,
                             max_step_retries=4,
                             collective_timeout_s=60.0,
                             step_timeout_s=120.0,
                             recover_timeout_s=120.0))

    def inject(self, rules: Tuple[str, ...]) -> threading.Event:
        """Queue trainer-scope rules; returns an event set once the
        faulted epoch completed and every rank disarmed."""
        done = threading.Event()
        self._rules.put((rules, done))
        return done

    def stop(self) -> None:
        self._halt.set()

    @property
    def epoch_sum(self) -> float:
        return float(sum(2 * i for i in range(self.EPOCH_N)))

    def _arm_all(self, rules: Tuple[str, ...]) -> None:
        tr = self.trainer
        victim = tr.workers[0][0]
        refs = []
        for s in tr.workers:
            for h in s:
                for rule in rules:
                    ph = (rule if h is victim
                          else re.sub(r"@\d+", "@999", rule)
                          if "@" in rule else rule + "@999")
                    refs.append(h.arm.remote(ph))
        ray_tpu_torch.get(refs, timeout=60)

    def _disarm_all(self) -> None:
        tr = self.trainer
        ray_tpu_torch.get([h.disarm.remote()
                     for s in tr.workers for h in s], timeout=60)

    def run(self) -> None:
        from ray_tpu_torch import data as rdata
        from ray_tpu_torch.train.ingest import to_numpy_batch
        self.trainer = self._build()
        self.trainer.start()
        epoch = 0
        try:
            while not self._halt.is_set():
                pending = None
                try:
                    pending = self._rules.get_nowait()
                except queue.Empty:
                    pass
                if pending is not None:
                    try:
                        self._arm_all(pending[0])
                    except Exception as e:
                        self.failures.append(f"arm failed: {e!r}")
                epoch += 1
                try:
                    self._run_epoch(rdata, to_numpy_batch, epoch)
                    self.epochs_ok += 1
                except Exception as e:
                    self._record_epoch_failure(epoch, e)
                    self._rebuild()
                if pending is not None:
                    try:
                        self._disarm_all()
                    except Exception as e:
                        self.failures.append(f"disarm failed: {e!r}")
                    pending[1].set()
        finally:
            try:
                self.trainer.shutdown()
            except Exception:
                pass    # teardown best-effort

    def _run_epoch(self, rdata, to_numpy_batch, epoch: int) -> None:
        per = self.EPOCH_N // self.EPOCH_BLOCKS
        ds = rdata.range(self.EPOCH_N,
                         parallelism=self.EPOCH_BLOCKS).map_batches(
            lambda b: {"x": b["id"].astype(np.float64) * 2.0})
        batches = (to_numpy_batch(b) for b in ds.iter_batches(
            batch_size=per, prefetch_batches=2))
        history = self.trainer.run_with_data(batches, keep_batches=6)
        # exactly-once proof: state advanced by exactly one analytic
        # epoch sum and steps by exactly EPOCH_BLOCKS, on EVERY rank
        # (a dropped or duplicated batch moves it off). History length
        # is advisory; state is the ground truth.
        del history
        self._expect_steps += self.EPOCH_BLOCKS
        self._expect_state += self.epoch_sum
        for steps, state in self.trainer.snapshots():
            if steps != self._expect_steps \
                    or not np.allclose(state, [self._expect_state]):
                self.numerics_ok = False
                self.failures.append(
                    f"epoch {epoch}: steps={steps} state={state!r} "
                    f"expected steps={self._expect_steps} "
                    f"state={self._expect_state}")

    def _record_epoch_failure(self, epoch: int, e: Exception) -> None:
        """Typed outcomes are ACCOUNTED, not lost: an epoch that
        surfaces the documented fault taxonomy (or the live-epoch
        transport-abort diagnosis, whose stated remedy — tear down and
        start fresh — ``_rebuild`` applies) reached a terminal typed
        state. Anything untyped (a raw ``TypeError`` escaping the
        recovery plane, say) is exactly what the no-lost-results
        invariant exists to catch."""
        from ray_tpu_torch.exceptions import (ActorError, CollectiveAbortError,
                                        GetTimeoutError,
                                        WorkerCrashedError)
        typed = isinstance(e, (ActorError, CollectiveAbortError,
                               GetTimeoutError, WorkerCrashedError)) \
            or (isinstance(e, RuntimeError)
                and "transport-abort marker" in str(e))
        if typed:
            self.recovered.append(
                f"epoch {epoch}: {type(e).__name__}")
        else:
            self.failures.append(f"epoch {epoch}: {e!r}")

    def _rebuild(self) -> None:
        """An epoch failure that escaped ``run_with_data``'s recovery
        may leave the slice set wedged (a live-epoch abort marker only
        re-forms through a gang restart the run already spent) — the
        operator move is tear-down-and-fresh-start. The failure stays
        recorded; the analytic trackers re-anchor at the fresh zero
        state so later epochs are still meaningfully checked."""
        try:
            self.trainer.shutdown()
        except Exception:
            pass    # wedged teardown is best effort
        self.trainer = self._build()
        self.trainer.start()
        self._expect_steps = 0
        self._expect_state = 0.0

    def stats(self) -> Dict[str, float]:
        return {"trainer_epochs_ok": self.epochs_ok,
                "trainer_recovered": len(self.recovered),
                "trainer_failures": len(self.failures)}


# ---------------------------------------------------------------------------
# churn lane


@ray_tpu_torch.remote(num_cpus=0, resources={"CHURN": 0.01}, max_retries=5)
def churn_task(ledger_dir: str, token: str, arm_dir: str):
    """One churn-lane task: claim any pending chaos arm-file (install
    its rule in THIS worker process — the kill then fires at a later
    churn exec's ENTRY, before any side effect, so the retry is
    exactly-once clean), then apply the token's side effect
    idempotently (exclusive create; a retry that finds the file
    simply skips)."""
    try:
        for fn in sorted(os.listdir(arm_dir)):
            if not fn.endswith(".rule"):
                continue
            src = os.path.join(arm_dir, fn)
            dst = src + ".claimed"
            try:
                os.rename(src, dst)    # atomic claim: exactly one winner
            except OSError:
                continue
            with open(dst, encoding="utf-8") as f:
                chaos.install(f.read().strip())
    except OSError:
        pass
    path = os.path.join(ledger_dir, token)
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.close(fd)
    except FileExistsError:
        pass        # idempotent replay: effect already applied
    return token


@ray_tpu_torch.remote(num_cpus=0, resources={"CHURN": 0.01}, max_restarts=0)
class ChurnActor:
    """Short-lived counter actor: spawned, bumped, asserted, killed —
    actor lifecycle churn under the same faults as the task lane."""

    def __init__(self):
        self.n = 0

    def inc(self):
        self.n += 1
        return self.n


class ChurnDriver(threading.Thread):
    """Continuous batches of idempotency-token tasks plus periodic
    actor lifecycle churn, all placed on the remote node (the real
    wire) via the CHURN resource."""

    def __init__(self, ledger_dir: str, arm_dir: str,
                 batch: int = 4, actor_every: int = 3):
        super().__init__(daemon=True, name="soak-churn")
        self.ledger_dir = ledger_dir
        self.arm_dir = arm_dir
        self.batch = batch
        self.actor_every = actor_every
        self.tokens: List[str] = []
        self.tasks_ok = 0
        self.actors_ok = 0
        self.lost: List[str] = []
        self._halt = threading.Event()

    def stop(self) -> None:
        self._halt.set()

    def arm(self, rules: Tuple[str, ...], phase: str) -> List[str]:
        """Drop one arm-file per rule for the next churn workers to
        claim; returns the file names (unclaimed ones are removed at
        disarm)."""
        names = []
        for j, rule in enumerate(rules):
            name = f"{phase}-{j}.rule"
            with open(os.path.join(self.arm_dir, name), "w",
                      encoding="utf-8") as f:
                f.write(rule)
            names.append(name)
        return names

    def disarm(self, names: List[str]) -> None:
        """Phase end: arm-files stay until claimed — a slow lane must
        still take its scheduled kill eventually. Late fires are safe:
        the replay digest covers the schedule (not fault landing
        times) and an exec-entry kill is exactly-once clean whenever
        it lands. Unclaimed files are swept at :meth:`sweep`."""

    def sweep(self) -> None:
        try:
            for fn in os.listdir(self.arm_dir):
                try:
                    os.unlink(os.path.join(self.arm_dir, fn))
                except OSError:
                    pass
        except OSError:
            pass

    def run(self) -> None:
        cycle = 0
        while not self._halt.is_set():
            cycle += 1
            toks = [f"c{cycle:04d}-{i}" for i in range(self.batch)]
            self.tokens.extend(toks)
            # explicit task name: the exec chaos point fires on it, so
            # the schedule's worker.exec.churn_task rules match (the
            # default name would be the full module path)
            refs = [churn_task.options(name="churn_task").remote(
                        self.ledger_dir, t, self.arm_dir)
                    for t in toks]
            try:
                vals = ray_tpu_torch.get(refs, timeout=120)
                if vals == toks:
                    self.tasks_ok += len(toks)
                else:
                    self.lost.append(
                        f"cycle {cycle}: wrong returns {vals!r}")
            except Exception as e:
                self.lost.append(f"cycle {cycle}: {e!r}")
            if cycle % self.actor_every == 0 and not self._halt.is_set():
                try:
                    a = ChurnActor.remote()
                    refs = [a.inc.remote() for _ in range(3)]
                    if ray_tpu_torch.get(refs, timeout=60)[-1] == 3:
                        self.actors_ok += 1
                    else:
                        self.lost.append(
                            f"cycle {cycle}: actor count drift")
                    ray_tpu_torch.kill(a)
                except Exception as e:
                    self.lost.append(f"cycle {cycle} actor: {e!r}")
            time.sleep(0.05)

    def ledger_ok(self) -> Tuple[bool, str]:
        """Exactly-once check: the applied-effect ledger holds exactly
        one entry per issued token (completed cycles only — tokens
        from a batch cut off by shutdown may legitimately be absent,
        so only missing-from-completed and unexpected entries fail)."""
        applied = {fn for fn in os.listdir(self.ledger_dir)}
        issued = set(self.tokens)
        stray = applied - issued
        if stray:
            return False, f"effects for never-issued tokens: {stray}"
        return True, ""

    def stats(self) -> Dict[str, float]:
        return {"churn_tasks_ok": self.tasks_ok,
                "churn_actors_ok": self.actors_ok,
                "churn_lost": len(self.lost)}


# ---------------------------------------------------------------------------
# restart-storm broadcast lane


@ray_tpu_torch.remote(num_cpus=0, resources={"CHURN": 0.01}, max_retries=5)
def storm_weights(cycle: int, n: int):
    return np.full(n, float(cycle), dtype=np.float64)


class StormDriver(threading.Thread):
    """The restart-storm broadcast lane (docs/object_plane.md): each
    cycle creates a fresh multi-chunk weights object on the remote
    node, then 8 driver-side consumers ``get()`` it CONCURRENTLY — one
    wire fetch drives the transfer, the rest attach to it, so
    ``ray_tpu_object_pulls{state="deduped"}`` must move over the run.
    Storm-scope chaos (``object.transfer.fetch`` drop/delay/sever)
    lands in this process's pull engine; the lane must ride it out
    through the typed retry/failover path. Lost results: an UNTYPED
    error surfacing from a pull, a consumer observing bytes that
    differ from its peers (the broadcast's byte-identical-seals
    contract), or a value off the analytic expectation."""

    def __init__(self, consumers: int = 8, n_elems: int = 192_000):
        super().__init__(daemon=True, name="soak-storm")
        self.consumers = consumers
        self.n_elems = n_elems      # * 8B ≈ 1.5MB: several wire chunks
        self.bcasts_ok = 0
        self.typed = 0
        self.lost: List[str] = []
        self._halt = threading.Event()

    def start(self) -> "StormDriver":
        super().start()
        return self

    def stop(self) -> None:
        self._halt.set()

    def run(self) -> None:
        import hashlib
        from ray_tpu_torch.exceptions import RayTpuError
        cycle = 0
        while not self._halt.is_set():
            cycle += 1
            ref = storm_weights.remote(cycle, self.n_elems)
            digests: List[Optional[str]] = [None] * self.consumers
            errs: List[str] = []
            lock = threading.Lock()

            def consume(k, want_cycle=cycle, ref=ref):
                try:
                    arr = ray_tpu_torch.get(ref, timeout=60)
                    if (arr.shape != (self.n_elems,)
                            or arr[0] != float(want_cycle)):
                        with lock:
                            errs.append(f"untyped: wrong value "
                                        f"shape={arr.shape}")
                        return
                    digests[k] = hashlib.sha256(arr.tobytes()).hexdigest()
                except RayTpuError:
                    # the documented taxonomy surfacing at get() — a
                    # legitimate outcome under chaos, never a loss
                    with lock:
                        errs.append("typed")
                except Exception as e:  # noqa: BLE001
                    with lock:
                        errs.append(f"untyped: {e!r}")

            threads = [threading.Thread(target=consume, args=(k,),
                                        daemon=True,
                                        name=f"soak-storm-c{k}")
                       for k in range(self.consumers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=90)
            untyped = [e for e in errs if e != "typed"]
            self.typed += len(errs) - len(untyped)
            got = [d for d in digests if d is not None]
            if untyped:
                self.lost.append(f"storm {cycle}: {untyped[0]}")
            elif len(set(got)) > 1:
                self.lost.append(
                    f"storm {cycle}: consumers sealed divergent bytes")
            elif got:
                self.bcasts_ok += 1
            self._halt.wait(0.2)

    def stats(self) -> Dict[str, float]:
        from ray_tpu_torch._private.object_transfer import pull_counters
        counters = pull_counters()      # driver-process pull engine
        return {"storm_bcasts_ok": self.bcasts_ok,
                "storm_typed": self.typed,
                "storm_pulls_started": counters["started"],
                "storm_pulls_deduped": counters["deduped"],
                "storm_pulls_rerouted": counters["rerouted"],
                "storm_lost": len(self.lost)}


# ---------------------------------------------------------------------------
# autoscaling lane


@ray_tpu_torch.remote(num_cpus=0, resources={"ELASTIC": 1}, max_retries=5)
def elastic_task(tag: str):
    return tag


class ScaleDriver(threading.Thread):
    """The autoscaling lane (docs/autoscaler.md): bursts of tasks
    demanding an ELASTIC resource NO base node carries, so every burst
    saturates past capacity, parks totals-infeasible, and completes
    only if the v2 autoscaler actually launches an elastic node and
    the parked work un-fences. The lane's chaos scope arms
    ``autoscaler.provider.launch`` / ``autoscaler.provider.boot``
    rules in the driver (the provider lives here), so lost launches
    and boot-then-die instances must converge through the retry
    budget for bursts to keep landing. Short idle/downscale timers
    make the elastic node drain-and-terminate between bursts,
    exercising the scale-down path every cycle."""

    def __init__(self, cluster, burst: int = 3):
        super().__init__(daemon=True, name="soak-scale")
        from ray_tpu_torch.autoscaler import NodeType
        from ray_tpu_torch.autoscaler.v2 import AutoscalerV2, FakeCloudProvider
        self.burst = burst
        self.provider = FakeCloudProvider(cluster, boot_delay_s=0.05)
        self.scaler = AutoscalerV2(
            self.provider,
            [NodeType("elastic", {"CPU": 2, "ELASTIC": 4},
                      max_workers=2)],
            idle_timeout_s=0.5, period_s=0.1, max_launch_attempts=8,
            upscale_delay_s=0.1, downscale_delay_s=0.5,
            request_timeout_s=0.5, allocate_timeout_s=5.0)
        self.bursts_ok = 0
        self.tasks_ok = 0
        self.lost: List[str] = []
        self._halt = threading.Event()

    def start(self) -> "ScaleDriver":
        self.scaler.start()
        super().start()
        return self

    def stop(self) -> None:
        self._halt.set()

    def run(self) -> None:
        cycle = 0
        while not self._halt.is_set():
            cycle += 1
            tags = [f"s{cycle:04d}-{i}" for i in range(self.burst)]
            refs = [elastic_task.remote(t) for t in tags]
            try:
                # generous bound: a burst rides out lost launches and
                # boot-then-die relaunches, but a burst that NEVER
                # un-fences is a lost result, not a hang
                vals = ray_tpu_torch.get(refs, timeout=60)
                if vals == tags:
                    self.bursts_ok += 1
                    self.tasks_ok += len(tags)
                else:
                    self.lost.append(
                        f"scale burst {cycle}: wrong returns {vals!r}")
            except Exception as e:
                self.lost.append(f"scale burst {cycle}: {e!r}")
            self._halt.wait(1.0)

    def shutdown_scaler(self) -> None:
        self.scaler.stop()

    def stats(self) -> Dict[str, float]:
        return {"scale_bursts_ok": self.bursts_ok,
                "scale_tasks_ok": self.tasks_ok,
                "scale_launch_retries": self.scaler.num_launch_retries,
                "scale_drains": self.scaler.num_drains,
                "scale_lost": len(self.lost)}
