"""The share of the training window in which the card was idle while the
program's ``rt.optim.update`` span was the innermost span open on the
training thread (``program_spans.idle_split``)."""

from portbench import program_spans

SPAN = "rt.optim.update"


def read(run):
    return program_spans.idle_share(run, SPAN)
