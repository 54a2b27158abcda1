"""Model FLOPs of the window's steps over the window at the bf16 peak
(``counts.model.train_step``: three forwards, causal attention at half,
recomputation not counted). Host clock."""

from portbench import peaks


def read(run):
    rec = run.record
    if not rec.get("steps"):
        return None
    return (100.0 * rec["steps"] * rec["flops_per_step"]
            / (rec["window_s"] * peaks.BF16_FLOPS))
