"""The attention backward's share of its roofline in the training window:
D = rowsum(dO * O), dQ and dK/dV together. Their time is that of every
kernel launched inside the backward of the flash op (the CPU op whose name
holds one of ``OPS``); the calls are the dQ kernels (``KERNELS``)
traced."""

from portbench.counts import attention

OPS = ("_FlashAttentionBackward",)
KERNELS = ("flash_bwd_dq",)


def read(run):
    shape = run.record.get("attn")
    if run.trace is None or not shape:
        return None
    t, calls = run.trace.under_op_s(OPS), run.trace.kernel_count(KERNELS)
    if not t or not calls:
        return None
    return 100.0 * calls * attention.least_s("bwd", *shape) / t
