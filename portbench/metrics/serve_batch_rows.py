"""Prompts a forward call of the deployment took, averaged over the
window's calls (``@serve.batch``'s realised batch size)."""


def read(run):
    batches = run.record.get("batches")
    if not batches:
        return None
    return sum(rows for rows, _, _, _ in batches) / len(batches)
