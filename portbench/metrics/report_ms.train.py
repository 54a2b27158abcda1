"""The mean host time of the window's ``train.report`` calls, from the
program's ``rt.train.report`` spans: the stop check to the report's file
on disk."""

from portbench import program_spans

SPAN = "rt.train.report"


def read(run):
    spans = program_spans.in_window(run)
    times = [t - s for s, t, name, _ in spans or () if name == SPAN]
    return 1e-6 * sum(times) / len(times) if times else None
