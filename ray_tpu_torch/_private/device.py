"""Device selection for the port's entry points. Torch is imported on the
first call, so that a process that runs no device path never loads it."""

from __future__ import annotations


def resolve_device(device) -> "torch.device":  # noqa: F821
    """``device`` as a ``torch.device``. The port's entry points default to
    ``"cuda"``; without a card they raise instead of moving to the CPU, which
    a caller must ask for by name."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
