"""The port's run device: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The run device: ``None`` means the card, and refuses without one.

    The port's entry points run on CUDA unless the caller asks for the
    CPU; they never fall back to it quietly.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available and no device was given: the "
                "port runs on the card by default; pass device='cpu' to run "
                "it on the CPU")
        return torch.device("cuda")
    return torch.device(device)
