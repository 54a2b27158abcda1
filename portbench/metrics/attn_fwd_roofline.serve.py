"""The flash forward kernels' share of their roofline while serving: each
forward's least time (``counts.attention.least_s`` at the padded batch the
deployment ran, every layer) summed over the window's forwards, over the
traced time of the kernels whose name holds one of ``KERNELS``."""

from portbench.counts import attention

KERNELS = ("flash_fwd",)


def read(run):
    batches = run.record.get("batches")
    if run.trace is None or not batches:
        return None
    t = run.trace.kernel_s(KERNELS)
    if not t:
        return None
    c = run.cell.config
    n, kv = c["num_attention_heads"], c["num_key_value_heads"]
    hd = c["hidden_size"] // n
    least = sum(attention.least_s("fwd", rows, s, n, kv, hd, True)
                for rows, s, _, _ in batches)
    return 100.0 * c["num_hidden_layers"] * least / t
