"""Where the port's state lives: the card unless the caller names another
device."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """None means the card: CUDA, and an error when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
