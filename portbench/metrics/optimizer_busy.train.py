"""The share of the training window in which the card ran the optimizer:
the time of every kernel launched inside the program's ``rt.optim.update``
span (``AdamW.update_``: the global norm, the clip and the update of each
leaf), over the window. The span reaches the trace as a CPU op, so the
cell's mix records CPU ops (``trace_ops``)."""

OPS = ("rt.optim.update",)


def read(run):
    if run.trace is None or not run.trace.window_s:
        return None
    t = run.trace.under_op_s(OPS)
    if not t:
        return None
    return 100.0 * t / run.trace.window_s
