"""Device resolution for the port's entry points.

The entry points run on the CUDA device unless the caller names another
device. Without a GPU and without an explicit device they raise: a run
meant for the card never quietly runs on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda`` (raises when no CUDA device is present);
    anything else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
