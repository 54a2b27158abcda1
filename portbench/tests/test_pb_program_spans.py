"""The readers of the program's spans (``program_spans.py`` and the metrics
built on it) on hand-built traces: the time-weighted split of idle time by
the innermost span of the training thread, against a count made by hand
and against a nanosecond-by-nanosecond count on random spans; and every
such metric has its file and its entry in ``BENCHMARK.json``."""

import random
import types

import pytest

from portbench import cells, program_spans, trace
from ray_tpu_torch.util.tracing import Span

MS = 1_000_000          # the hand-built times are in ms, on ns clocks
OFFSET = 500 * MS       # the profiler's clock less the host's
TRAIN, AUTOGRAD, DRIVER = 11, 12, 13
NEW = {"optimizer_busy.train": ("%", ["mistral7b.train.s4096"]),
       "idle_forward.train": ("%", ["mistral7b.train.s4096",
                                    "vitb16.train.b256"]),
       "idle_backward.train": ("%", ["mistral7b.train.s4096"]),
       "idle_optimizer.train": ("%", ["mistral7b.train.s4096",
                                      "vitb16.train.b256"]),
       "report_ms.train": ("ms", ["mistral7b.train.s4096",
                                  "vitb16.train.b256"])}


def _span(name, start, end, thread=TRAIN):
    return Span(name, start * MS, end * MS, thread)


# A window of 10,000 ms on the host's clock: one step, then its report.
SPANS = [
    _span("nested", 2000, 2500),
    _span("rt.train.forward", 1000, 4000),
    _span("on_autograd", 4500, 6000, thread=AUTOGRAD),
    _span("rt.train.backward", 4000, 7000),
    _span("rt.optim.update", 7000, 9000),
    _span("rt.train.step", 1000, 9000),
    _span("rt.train.report", 9000, 9500),
    _span("a_task", -100, 10100, thread=DRIVER),
    _span("rt.train.report", -300, -100),     # before the window
]
BUSY = [(1200, 2100), (2400, 3800), (4100, 6900), (7500, 8000),
        (8500, 8800)]
# idle: 0-1200, 2100-2400, 3800-4100, 6900-7500, 8000-8500, 8800-10000
SPLIT_MS = {"rt.train.forward": 200 + 200, "nested": 300,
            "rt.train.backward": 100 + 100, "rt.optim.update": 500 + 500
            + 200, "rt.train.report": 500, "rt.train.step": 0}


def _run(busy=BUSY, window=(0, 10_000), ops=None, links=None):
    """A traced run: the host's window, kernels on the profiler's clock."""
    spans = trace.Spans()
    spans.items.append((window[0] * MS, window[1] * MS, trace.WINDOW))
    links = links or [0] * len(busy)
    kernels = [(s * MS + OFFSET, t * MS + OFFSET, "k", link)
               for (s, t), link in zip(busy, links)]
    tr = trace.Trace(kernels, ops or {}, [],
                     (window[0] * MS + OFFSET, window[1] * MS + OFFSET))
    return types.SimpleNamespace(trace=tr, spans=spans, record={},
                                 cell=None)


@pytest.fixture
def spans(monkeypatch):
    held = list(SPANS)
    monkeypatch.setattr(program_spans, "recorded", lambda: held)
    return held


def _read(name, run):
    return cells.metric_reader(name)(run)


def test_idle_split_by_the_training_threads_innermost_span(spans):
    run = _run()
    split = program_spans.idle_split(run)
    assert split == pytest.approx({k: v / 1e3
                                   for k, v in SPLIT_MS.items()})
    # the autograd thread's and the driver's spans label nothing
    assert "on_autograd" not in split and "a_task" not in split
    idle = _read("device_idle.train", run)
    assert idle == pytest.approx(41.0)
    shares = {m: _read(m, run) for m in ("idle_forward.train",
                                         "idle_backward.train",
                                         "idle_optimizer.train")}
    assert shares == pytest.approx({"idle_forward.train": 4.0,
                                    "idle_backward.train": 2.0,
                                    "idle_optimizer.train": 12.0})
    assert sum(shares.values()) <= idle
    assert sum(split.values()) <= idle / 100 * run.trace.window_s


def test_report_ms_reads_the_windows_reports(spans):
    assert _read("report_ms.train", _run()) == pytest.approx(500.0)


def test_optimizer_busy_reads_kernels_launched_in_the_update(spans):
    # ops on the profiler's clock: the update span as a CPU op, and the
    # ops that launched each kernel
    ops = {1: (TRAIN, 7000 * MS + OFFSET, 9000 * MS + OFFSET,
               "rt.optim.update"),
           2: (TRAIN, 7100 * MS + OFFSET, 7200 * MS + OFFSET,
               "aten::mul_"),
           3: (TRAIN, 8400 * MS + OFFSET, 8450 * MS + OFFSET,
               "aten::add_"),
           4: (TRAIN, 1100 * MS + OFFSET, 1150 * MS + OFFSET, "aten::mm"),
           5: (AUTOGRAD, 7300 * MS + OFFSET, 7350 * MS + OFFSET,
               "aten::mm")}
    run = _run(ops=ops, links=[4, 4, 5, 2, 3])
    assert _read("optimizer_busy.train", run) == pytest.approx(8.0)


def test_readers_find_nothing_without_program_spans(monkeypatch):
    """A program without the recorder (the parent of this reader), or a
    run without a trace or without a span of the metric's name."""
    monkeypatch.setattr(program_spans, "recorded", lambda: None)
    for name in NEW:
        assert _read(name, _run()) is None
    monkeypatch.setattr(program_spans, "recorded", lambda: [])
    assert _read("idle_forward.train", _run()) is None
    vit = [sp for sp in SPANS if sp.name != "rt.train.backward"]
    monkeypatch.setattr(program_spans, "recorded", lambda: vit)
    assert _read("idle_backward.train", _run()) is None
    assert _read("idle_forward.train", _run()) == pytest.approx(4.0)
    no_trace = _run()
    no_trace.trace = None
    for name in NEW:
        assert _read(name, no_trace) is None


@pytest.mark.parametrize("seed", range(6))
def test_idle_split_matches_a_count_of_each_instant(monkeypatch, seed):
    """Random nested spans on the training thread and random kernels: the
    split equals a count, instant by instant, of the innermost span open
    over each idle nanosecond."""
    rng = random.Random(seed)
    horizon = 400

    def nest(lo, hi, depth, out):
        at = lo
        while depth < 4 and at < hi - 2 and rng.random() < 0.8:
            s = rng.randint(at, hi - 2)
            t = rng.randint(s + 1, hi)
            out.append(Span(rng.choice(["a", "b", "c", program_spans
                                        .FORWARD]), s, t, TRAIN))
            nest(s, t, depth + 1, out)
            at = t
        return out

    spans = nest(-20, horizon + 20, 0, [])
    spans.append(Span(program_spans.FORWARD, 5, 6, TRAIN))
    busy, at = [], 0
    while at < horizon:
        s = at + rng.randint(0, 15)
        t = s + rng.randint(1, 25)
        busy.append((s, min(t, horizon)))
        at = t + 1
    monkeypatch.setattr(program_spans, "recorded", lambda: spans)
    run = types.SimpleNamespace(
        trace=trace.Trace([(s, t, "k", 0) for s, t in busy if t > s], {},
                          [], (0, horizon)),
        spans=types.SimpleNamespace(window=lambda: (0, horizon)))
    want = {sp.name: 0 for sp in spans}
    for ns in range(horizon):
        if any(s <= ns < t for s, t in busy):
            continue
        open_ = [sp for sp in spans if sp.start_ns <= ns < sp.end_ns]
        if open_:
            inner = max(open_, key=lambda sp: (sp.start_ns, -sp.end_ns))
            want[inner.name] += 1
    got = program_spans.idle_split(run)
    assert {k: v for k, v in got.items() if v} == pytest.approx(
        {k: v / 1e9 for k, v in want.items() if v})
    idle = 1.0 - run.trace.busy_s() / run.trace.window_s
    assert sum(got.values()) <= idle * run.trace.window_s + 1e-15


def test_every_new_metric_has_its_file_and_entry():
    entries = {m["name"]: m for m in cells.benchmark()["per_layer"]}
    for name, (unit, workloads) in NEW.items():
        m = entries[name]
        assert (m["unit"], m["workloads"]) == (unit, workloads)
        assert (m["source"], m["moves"], m["better"]) == (
            "program_span", "train_tokens_per_s", "lower")
        assert callable(cells.metric_reader(name))
