"""Model FLOPs of the served prompts' real tokens (padding not counted)
over the summed time of the deployment's forward calls, at the bf16
peak. Each forward call is timed by the deployment on the host clock,
from the padded batch to its answers on the host."""

from portbench import peaks
from portbench.counts import model


def read(run):
    batches = run.record.get("batches")
    if not batches:
        return None
    c = run.cell.config
    flops = sum(model.decoder_forward(c, n) for _, _, lengths, _ in batches
                for n in lengths)
    seconds = sum(f for _, _, _, f in batches)
    return 100.0 * flops / (seconds * peaks.BF16_FLOPS)
