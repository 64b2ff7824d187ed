"""Where the port runs: the card, unless the caller asks for the CPU."""
from __future__ import annotations

import os

import torch


def resolve(device=None) -> torch.device:
    """``None`` means the CUDA card (``cuda:$LOCAL_RANK`` where a launcher
    such as ``torchrun`` sets it), and raises when there is none; any
    other value is taken as the caller's explicit choice (the tests pass
    ``"cpu"``).  There is no silent fallback to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the card by default; "
                "pass device='cpu' to run on the CPU")
        local = os.environ.get("LOCAL_RANK")
        return (torch.device("cuda") if local is None
                else torch.device("cuda", int(local)))
    return torch.device(device)
