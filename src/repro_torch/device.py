"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card.

    Entry points run on the card unless the caller asks for another device
    (the CPU tests pass ``device="cpu"``).  With no device on a host without
    CUDA this raises instead of carrying on on the CPU.
    """
    if device is not None:
        d = torch.device(device)
        if d.type == "cuda" and d.index is None:
            # "cuda" and "cuda:0" must compare equal to tensors' devices
            d = torch.device("cuda", torch.cuda.current_device())
        return d
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU explicitly")
    return torch.device("cuda", torch.cuda.current_device())
