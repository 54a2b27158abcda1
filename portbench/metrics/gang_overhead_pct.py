"""The share of the training window outside the loop's step calls: the
feed, ``train.report`` and Train's own work between steps. Each step call
ends when its loss is on the host. Host clock, the loop's own spans."""


def read(run):
    rec = run.record
    if not rec.get("steps"):
        return None
    return 100.0 * (rec["window_s"] - rec["step_s"]) / rec["window_s"]
