"""The flash forward kernels' share of their roofline in the training
window: a call's least time (``counts.attention.least_s`` at the step's
shape) times the calls traced, over the traced time of the kernels whose
name holds one of ``KERNELS``."""

from portbench.counts import attention

KERNELS = ("flash_fwd",)


def read(run):
    shape = run.record.get("attn")
    if run.trace is None or not shape:
        return None
    t, calls = run.trace.kernel_s(KERNELS), run.trace.kernel_count(KERNELS)
    if not t or not calls:
        return None
    return 100.0 * calls * attention.least_s("fwd", *shape) / t
