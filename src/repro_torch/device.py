"""Device resolution for the port's entry points.

Every entry point that can run on the card takes a ``device`` argument.
``None`` means the card: the port runs on CUDA unless the caller asks for
the CPU, and it never falls back to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None") -> torch.device:
    """``None`` -> ``cuda`` (raising when no card is visible); anything
    else is passed through ``torch.device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available (torch.cuda.is_available() is "
                "False); pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
