"""Serving through ``ray_tpu_torch.serve``: an open loop of prompts to
score, sent through a ``DeploymentHandle`` to one replica of one card.

The deployment is the benchmark's own user code. ``@serve.batch`` gathers
up to the mix's ``max_batch_size`` prompts, waiting at most
``batch_wait_ms``; the deployment pads them on the right to the longest,
runs the program's ``forward`` and answers each prompt with the token the
model puts first after each of its positions (the greedy prediction, the
prefill of a request). Each request is sent when it is due, whatever came
before; its latency runs from when it was due to when its answer is back.
"""

from __future__ import annotations

import math
import sys
import threading
import time
import uuid
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from portbench import feed, program, trace, weights
from portbench.reference import serve_check

RUNS: Dict[str, "object"] = {}
DRAIN_S = 60.0        # how long past the window an answer may come


class Scorer:
    """The deployment: the program's decoder on this replica's card."""

    def __init__(self, key: str):
        from ray_tpu_torch.models import transformer
        r = RUNS[key]
        c, traffic = r.cell.config, r.cell.traffic
        self.forward = transformer.forward
        self.cfg = program.config(c, traffic)
        self.device = r.device
        self.spans = r.spans
        self.params = weights.make(c, r.seed, r.device)
        self.batches: List[tuple] = []
        with torch.no_grad():
            for rows, length in feed.warm_shapes(traffic):
                self._run(np.zeros((rows, length), dtype=np.int64))

    def _run(self, tokens: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(tokens).to(self.device)
        logits = self.forward(self.params, t, self.cfg)
        return logits.argmax(dim=-1).to(torch.int32).cpu().numpy()

    async def score(self, prompts):
        with self.spans.span("pb.forward"), torch.no_grad():
            t0 = time.perf_counter()
            lengths = [len(p) for p in prompts]
            tokens = np.zeros((len(prompts), max(lengths)), dtype=np.int64)
            for i, p in enumerate(prompts):
                tokens[i, :len(p)] = p
            ids = self._run(tokens)
            forward_s = time.perf_counter() - t0
        self.batches.append((len(prompts), tokens.shape[1], lengths,
                             forward_s))
        return [(ids[i, :n], forward_s) for i, n in enumerate(lengths)]

    def record(self):
        return list(self.batches)


def deployment_class(traffic: Dict):
    from ray_tpu_torch import serve

    class Deployment(Scorer):
        score = serve.batch(max_batch_size=traffic["max_batch_size"],
                            batch_wait_timeout_ms=traffic["batch_wait_ms"])(
            Scorer.score)

    return Deployment


class OpenLoop:
    """Requests sent through ``score`` when due, by one thread; one other
    thread takes the answers in the order the requests were sent, blocked
    on the oldest outstanding one (one replica answers in order), and
    notes when each comes back. Two threads whatever the backlog, and
    neither polls: the load takes little of the process the program runs
    in."""

    def __init__(self, requests: List[feed.Request], spans: trace.Spans):
        self.requests = requests
        self.spans = spans
        n = len(requests)
        self.done = [None] * n          # when the answer came back
        self.answers = [None] * n
        self.errors = [None] * n
        self.late_s = 0.0               # how far the sender fell behind
        self._sent: List[tuple] = []    # (ref, request index), in order
        self._sent_all = False
        self._cv = threading.Condition()

    def _finish(self, i, answer=None, error=None):
        self.answers[i], self.errors[i] = answer, error
        self.done[i] = time.perf_counter()

    def _collect(self, deadline: float) -> None:
        import ray_tpu_torch as rt
        from ray_tpu_torch.exceptions import GetTimeoutError
        taken = 0
        while True:
            with self._cv:
                while taken == len(self._sent) and not self._sent_all:
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        return
                    self._cv.wait(timeout=left)
                if taken == len(self._sent):
                    return
                ref, i = self._sent[taken]
            taken += 1
            try:
                answer = rt.get(ref, timeout=max(
                    0.0, deadline - time.perf_counter()))
            except GetTimeoutError:
                return          # this one and the rest never came back
            except Exception as e:      # the request failed: it is missing
                self._finish(i, error=repr(e))
                continue
            self._finish(i, answer=answer)

    def run(self, score, seconds: float) -> float:
        """Send every request when due from now; wait for the answers up
        to ``DRAIN_S`` past ``seconds``. Returns the start."""
        self.start = start = time.perf_counter()
        waiter = threading.Thread(target=self._collect,
                                  args=(start + seconds + DRAIN_S,),
                                  name="portbench-answers", daemon=True)
        waiter.start()
        for req in self.requests:
            wait = start + req.due_s - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            self.late_s = max(self.late_s, -wait)
            with self.spans.span("pb.send"):
                try:
                    ref = score.remote(req.tokens)
                except Exception as e:      # refused: it is missing
                    self._finish(req.index, error=repr(e))
                    continue
            with self._cv:
                self._sent.append((ref, req.index))
                self._cv.notify()
        with self._cv:
            self._sent_all = True
            self._cv.notify()
        waiter.join(timeout=seconds + DRAIN_S + 60)
        return start

    def latencies(self) -> List[float]:
        """Each request's latency from when it was due; infinite for one
        that failed or never came back."""
        return [math.inf if self.done[q.index] is None
                or self.errors[q.index] is not None
                else self.done[q.index] - (self.start + q.due_s)
                for q in self.requests]


def deploy(r):
    """The deployment on one card, its every batch shape warmed; returns
    its handle."""
    from ray_tpu_torch import serve
    key = uuid.uuid4().hex
    RUNS[key] = r
    dep = serve.deployment(
        name=f"portbench-{key[:8]}",
        ray_actor_options={"num_gpus": 1})(deployment_class(r.cell.traffic))
    handle = serve.run(dep.bind(key), timeout=900)
    r.sync()
    return handle


def run(r) -> None:
    from ray_tpu_torch import serve
    import ray_tpu_torch as rt
    c, traffic = r.cell.config, r.cell.traffic
    requests = feed.requests(c, traffic, r.seed, r.seconds)
    loop = OpenLoop(requests, r.spans)
    program.start_runtime(r.device)
    r.mark("the runtime is up")
    try:
        handle = deploy(r)
        r.mark("the deployment is up, every shape warmed")
        with trace.capture(r.device, r.spans, r.traced,
                           traffic.get("trace_ops", False)) as held:
            with r.spans.span(trace.WINDOW), record_function(trace.WINDOW):
                r.window_start = loop.run(handle.score, r.seconds)
        r.memory_peak_bytes = r.peak_memory()
        r.trace = held.trace
        r.record["batches"] = rt.get(handle.record.remote(), timeout=120)
        serve.shutdown()
    finally:
        program.stop_runtime()
        RUNS.clear()
    r.free_device()

    latencies = loop.latencies()
    overheads = []
    for q in requests:
        i = q.index
        if loop.done[i] is None:
            r.faults.append(f"request {i} never came back")
        elif loop.errors[i] is None:
            ids, forward_s = loop.answers[i]
            overheads.append(latencies[i] - forward_s)
            if len(ids) != len(q.tokens):
                r.faults.append(f"request {i}: {len(ids)} answers for "
                                f"{len(q.tokens)} positions")
    r.attempted = len(requests)
    r.failed = sum(math.isinf(x) for x in latencies)
    r.end_to_end["serve_p95_ms"] = 1e3 * percentile(latencies, 0.95)
    r.end_to_end["serve_p50_ms"] = 1e3 * percentile(latencies, 0.50)
    r.record["overheads_s"] = overheads

    answered = [q for q in requests if loop.answers[q.index] is not None
                and len(loop.answers[q.index][0]) == len(q.tokens)]
    if not answered:
        r.faults.append("no request came back to check")
        return
    sample = check_sample(answered, traffic, r.seed)
    gaps = serve_check.widest_gaps(
        c, r.seed, r.device, [q.tokens for q in sample],
        [loop.answers[q.index][0] for q in sample])
    r.numbers["served_gap"] = gaps["served"]
    print(f"serve: the sender fell behind by {loop.late_s:.6f} s at most; "
          f"{gaps['positions']} served positions checked", file=sys.stderr)


def check_sample(requests, traffic, seed):
    """The longest request and others drawn from the seed, up to the mix's
    budget of checked positions."""
    longest = max(requests, key=lambda q: len(q.tokens))
    rng = np.random.default_rng((seed & weights.MASK64) ^ 0x5EED)
    sample, budget = [longest], traffic["check_tokens"] - len(longest.tokens)
    for j in rng.permutation(len(requests)):
        q = requests[int(j)]
        if q is not longest and len(q.tokens) <= budget:
            sample.append(q)
            budget -= len(q.tokens)
    return sample


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank ``q`` quantile; a missing request is infinite."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]
