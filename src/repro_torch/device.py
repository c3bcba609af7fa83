"""Device selection shared by the entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU.  Asking for
``cuda`` on a machine without a card raises: nothing carries on quietly on
the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() is "
            "False; pass --device cpu (CLIs) or device='cpu' to run the "
            "plain-PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def generator(seed: int, device: torch.device | str = "cpu") -> torch.Generator:
    """A seeded ``torch.Generator`` on ``device``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(seed)
    return g
