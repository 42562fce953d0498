"""Device selection shared by the port's entry points: "cuda" is the
default everywhere and raises without a card; "cpu" runs only when a
caller asks for it (as the CPU tests do)."""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """The device an entry point runs on; "cuda" becomes the current
    card's index (cuda:0), as the tensors made there report it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch.cuda.is_available() "
                               "is False; pass device='cpu' to run on the "
                               "CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
