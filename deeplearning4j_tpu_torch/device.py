"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` when the caller names one, else the first CUDA card.

    Raises when no card is present and no device was named: an entry
    point of the port runs on the CPU only when asked to, never as a
    quiet fallback. A CUDA device always comes back with its index
    (``torch.cuda.set_device`` in a worker thread needs one)."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    elif not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return torch.device("cuda", torch.cuda.current_device())
