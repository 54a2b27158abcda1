"""The program's own spans in a traced run, and the card's idle time split
by them.

The program (``ray_tpu_torch.util.tracing``) records a span while a
``torch.profiler`` capture runs in its process, in ``time.time_ns()``,
the clock of the benchmark's ``Spans``; the spans of the traced window are
moved onto the device trace's clock by the offset ``Trace`` measured
(``run.trace.window[0] - run.spans.window()[0]``). A program without the
recorder gives no spans, and every reader built on this module then
returns None.

``idle_split`` labels each idle instant of the window (no operation on
the card) with the innermost program span open at that instant on the
training thread, the thread that opened ``FORWARD``: each instant counts
once, under one label, so the shares of one thread sum to no more than the
window's idle share.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

FORWARD = "rt.train.forward"


def recorded() -> Optional[list]:
    """The program's closed spans (``tracing.Span``), or None where the
    program has no recorder."""
    try:
        from ray_tpu_torch.util.tracing import recorded_spans
    except ImportError:
        return None
    return recorded_spans()


def in_window(run) -> Optional[List[tuple]]:
    """``(start_ns, end_ns, name, thread)`` of each program span
    that overlaps the traced window, on the trace's clock; None without a
    trace or a span."""
    if run.trace is None:
        return None
    spans = recorded()
    if not spans:
        return None
    offset = run.trace.window[0] - run.spans.window()[0]
    lo, hi = run.trace.window
    out = [(s.start_ns + offset, s.end_ns + offset, s.name, s.thread)
           for s in spans
           if s.end_ns + offset > lo and s.start_ns + offset < hi]
    return out or None


def training_thread(spans: List[tuple]) -> Optional[int]:
    """The thread that opened the most ``FORWARD`` spans."""
    counts: Dict[int, int] = {}
    for _, _, name, thread in spans:
        if name == FORWARD:
            counts[thread] = counts.get(thread, 0) + 1
    return max(counts, key=counts.get) if counts else None


def innermost(spans: List[Tuple[int, int, str]]
              ) -> List[Tuple[int, int, str]]:
    """Disjoint ``(start, end, name)`` pieces, in order, each labelled with
    the innermost of ``spans`` open over it: the one opened last, and of
    those opened together the shortest."""
    spans = [sp for sp in spans if sp[1] > sp[0]]
    events = sorted([(s, 1, i) for i, (s, t, _) in enumerate(spans)]
                    + [(t, 0, i) for i, (s, t, _) in enumerate(spans)])
    out: List[Tuple[int, int, str]] = []
    active: set = set()
    prev = None
    for at, opens, i in events:
        if active and prev is not None and at > prev:
            inner = max(active, key=lambda j: (spans[j][0], -spans[j][1]))
            out.append((prev, at, spans[inner][2]))
        prev = at
        if opens:
            active.add(i)
        else:
            active.discard(i)
    return out


def idle_intervals(trace) -> List[Tuple[int, int]]:
    """The window's instants with no operation on the card."""
    out, prev = [], trace.window[0]
    for s, t in trace._busy_intervals():
        if s > prev:
            out.append((prev, s))
        prev = max(prev, t)
    if trace.window[1] > prev:
        out.append((prev, trace.window[1]))
    return out


def idle_split(run) -> Optional[Dict[str, float]]:
    """Idle seconds of the window by the innermost program span open on
    the training thread, for each name that thread opened (idle time under
    none of its spans is left out); None without a training thread."""
    spans = in_window(run)
    thread = training_thread(spans) if spans else None
    if thread is None:
        return None
    lo, hi = run.trace.window
    mine = [(max(s, lo), min(t, hi), name)
            for s, t, name, th in spans if th == thread]
    pieces = innermost(mine)
    split: Dict[str, float] = {name: 0.0 for _, _, name in mine}
    i = 0
    for s, t in idle_intervals(run.trace):
        while i < len(pieces) and pieces[i][1] <= s:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < t:
            a, b, name = pieces[j]
            split[name] += (min(b, t) - max(a, s)) / 1e9
            j += 1
    return split


def idle_share(run, name: str) -> Optional[float]:
    """Percent of the window idle with ``name`` the innermost span open on
    the training thread; None where that thread opened no such span."""
    split = idle_split(run)
    if split is None or name not in split or not run.trace.window_s:
        return None
    return 100.0 * split[name] / run.trace.window_s
