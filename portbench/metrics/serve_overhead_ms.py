"""The median over answered requests of a request's latency (from when it
was due) less its batch's forward time, as the deployment recorded it:
the handle, the router, ``@serve.batch``'s gathering and waiting, the
queue behind earlier batches, and the answer's way back."""

import statistics


def read(run):
    over = run.record.get("overheads_s")
    return 1e3 * statistics.median(over) if over else None
