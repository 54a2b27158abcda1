"""Spans on the host's clock, and the device trace of a ``--trace 1`` run.

``Spans`` records the benchmark's own spans (``pb.window`` around the
measured window, ``pb.step``, ``pb.feed``, ``pb.report``, ``pb.forward``,
``pb.send``) in ``time.time_ns()``, from any thread.

``capture()`` runs ``torch.profiler`` with CUDA activity and, where the
mix asks for it (``trace_ops``), the CPU ops of every thread: the flash
backward runs on autograd's own thread, and only its op says which kernels
it launched. Recording every CPU op costs the host time, so a mix that
needs no op records only the device. The profiler's clock is Unix time in
ns, as ``time.time_ns()``; where ops are recorded, the ``pb.window``
annotation measures the offset between the two and the spans are moved by
it. What is read, inside the window alone:

- ``busy_s``: the union of the intervals in which a device operation ran;
- ``kernel_s(names)``: the time of the kernels whose name holds one of
  ``names``;
- ``under_op_s(ops)``: the time of the kernels launched while a CPU op
  whose name holds one of ``ops`` was open on the launching thread (a
  kernel's ``linked_correlation_id`` names the op that launched it);
- ``breakdown()``: device time by kind of kernel (``KINDS``, the classes of
  ``chip_smoke.py::profile_device``) and idle time by what the host was
  doing (the innermost span open when the gap began).
"""

from __future__ import annotations

import bisect
import contextlib
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

WINDOW = "pb.window"
# Kinds of device operation, by a piece of the kernel's name in lower case;
# the first kind that matches takes it.
KINDS = (("attention kernels", ("flash_",)),
         ("collectives (NCCL)", ("nccl",)),
         ("matmuls", ("nvjet", "gemm", "xmma", "cutlass")),
         ("casts and copies", ("copy", "memcpy", "memset")),
         ("reductions", ("reduce",)),
         ("softmax", ("softmax",)),
         ("other elementwise", ("elementwise",)))


def kind_of(name: str) -> str:
    low = name.lower()
    return next((kind for kind, keys in KINDS
                 if any(key in low for key in keys)), "other")


class Spans:
    """Named intervals on the host's clock, from any thread."""

    def __init__(self):
        self.items: List[Tuple[int, int, str]] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        start = time.time_ns()
        try:
            yield
        finally:
            with self._lock:
                self.items.append((start, time.time_ns(), name))

    def window(self) -> Tuple[int, int]:
        return next((s, t) for s, t, n in self.items if n == WINDOW)


@contextlib.contextmanager
def capture(device, spans: Spans, enabled: bool, ops: bool):
    """Yields a holder whose ``trace`` is the ``Trace`` of the block once
    it ends; None when not ``enabled`` or on a CPU device."""
    holder = _Holder()
    if not enabled or torch.device(device).type != "cuda":
        yield holder
        return
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ops
                                            else [])
    prof = profile(activities=activities,
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=ops))
    prof.start()
    try:
        yield holder
    finally:
        torch.cuda.synchronize()
        prof.stop()
    holder.trace = Trace.from_kineto(prof.profiler.kineto_results.events(),
                                     spans)


class _Holder:
    trace: Optional["Trace"] = None


class Trace:
    def __init__(self, kernels, ops, spans, window):
        self.kernels = kernels   # (start_ns, end_ns, name, linked op id)
        self.ops = ops           # op id -> (thread, start_ns, end_ns, name)
        self.spans = spans       # host spans (start_ns, end_ns, name)
        self.window = window     # (start_ns, end_ns)

    @classmethod
    def from_kineto(cls, events, host: Spans) -> "Trace":
        cuda = torch.autograd.DeviceType.CUDA
        kernels, ops, cpu_names, marked = [], {}, set(), None
        for e in events:
            start, dur = e.start_ns(), e.duration_ns()
            if e.device_type() == cuda:
                kernels.append((start, start + dur, e.name(),
                                e.linked_correlation_id()))
                continue
            cpu_names.add(e.name())
            if e.name() == WINDOW:
                marked = start
            if e.linked_correlation_id() == 0:  # an op, not a CUDA API call
                ops[e.correlation_id()] = (e.start_thread_id(), start,
                                           start + dur, e.name())
        # a CPU span (record_function) is also drawn on the device's line
        # under its own name; no kernel bears the name of a CPU event
        lo, hi = host.window()
        offset = 0 if marked is None else marked - lo
        print(f"trace: profiler clock - host clock = {offset} ns "
              f"({'measured' if marked is not None else 'assumed'})",
              file=sys.stderr)
        lo, hi = lo + offset, hi + offset
        kernels = sorted((max(s, lo), min(t, hi), n, c)
                         for s, t, n, c in kernels
                         if t > lo and s < hi and n not in cpu_names)
        spans = sorted((s + offset, t + offset, n) for s, t, n in host.items
                       if n != WINDOW)
        return cls(kernels, ops, spans, (lo, hi))

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def _busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[Tuple[int, int]] = []
        for s, t, _, _ in self.kernels:
            if merged and s <= merged[-1][1]:
                if t > merged[-1][1]:
                    merged[-1] = (merged[-1][0], t)
            else:
                merged.append((s, t))
        return merged

    def busy_s(self) -> float:
        return sum(t - s for s, t in self._busy_intervals()) / 1e9

    def kernel_s(self, names: Sequence[str]) -> float:
        return sum(t - s for s, t, n, _ in self.kernels
                   if any(k in n for k in names)) / 1e9

    def kernel_count(self, names: Sequence[str]) -> int:
        return sum(1 for _, _, n, _ in self.kernels
                   if any(k in n for k in names))

    def under_op_s(self, op_names: Sequence[str]) -> float:
        """Time of the kernels launched inside an op named in
        ``op_names`` (a substring of its name), on the launching
        thread; 0 where no CPU op was recorded."""
        by_thread: Dict[int, List[Tuple[int, int]]] = {}
        for thread, s, t, name in self.ops.values():
            if any(k in name for k in op_names):
                by_thread.setdefault(thread, []).append((s, t))
        # the ops of one thread nest or follow each other: keep their
        # union, disjoint intervals in order
        for thread, iv in by_thread.items():
            iv.sort()
            union: List[Tuple[int, int]] = []
            for s, t in iv:
                if union and s <= union[-1][1]:
                    union[-1] = (union[-1][0], max(union[-1][1], t))
                else:
                    union.append((s, t))
            by_thread[thread] = union
        starts = {th: [s for s, _ in iv] for th, iv in by_thread.items()}
        total = 0
        for s, t, _, link in self.kernels:
            op = self.ops.get(link)
            if op is None or op[0] not in by_thread:
                continue
            at = op[1]
            i = bisect.bisect_right(starts[op[0]], at) - 1
            if i >= 0 and at <= by_thread[op[0]][i][1]:
                total += t - s
        return total / 1e9

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        kinds: Dict[str, float] = {}
        for s, t, n, _ in self.kernels:
            kinds[kind_of(n)] = kinds.get(kind_of(n), 0.0) + (t - s) / 1e9
        gaps: Dict[str, float] = {}
        # sweep the spans in time order; the label of a gap is the
        # innermost (shortest) span open where it begins
        spans, nxt, active = self.spans, 0, []
        prev = self.window[0]
        for s, t in self._busy_intervals() + [(self.window[1],) * 2]:
            if s > prev:
                while nxt < len(spans) and spans[nxt][0] <= prev:
                    active.append(spans[nxt])
                    nxt += 1
                active = [sp for sp in active if sp[1] >= prev]
                label = (min(active, key=lambda sp: sp[1] - sp[0])[2]
                         if active else "no benchmark span open")
                gaps[label] = gaps.get(label, 0.0) + (s - prev) / 1e9
            prev = max(prev, t)
        return {"device_ops": sorted(kinds.items(), key=lambda x: -x[1])[:top],
                "idle_gaps": sorted(gaps.items(), key=lambda x: -x[1])[:top]}

    def top_kernels(self, top: int = 12) -> List[Tuple[str, float, int]]:
        totals: Dict[str, List] = {}
        for s, t, n, _ in self.kernels:
            e = totals.setdefault(n, [0.0, 0])
            e[0] += (t - s) / 1e9
            e[1] += 1
        ranked = sorted(totals.items(), key=lambda x: -x[1][0])[:top]
        return [(n[:120], v[0], v[1]) for n, v in ranked]
