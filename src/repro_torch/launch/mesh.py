"""The mesh the training loop runs under, on one device.

Counterpart of ``make_host_mesh`` in ``src/repro/launch/mesh.py``.  The
reference builds a ``jax.sharding.Mesh`` over every device and enters it
as a context manager around its steps; the port's one-device mesh names
its device (the card unless the caller names the CPU) and makes it the
current CUDA device inside its ``with`` block.  Multi-device meshes are
ROADMAP item 12e.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from ..device import resolve_device


@dataclass
class HostMesh:
    device: torch.device

    def __enter__(self) -> "HostMesh":
        self._ctx = (torch.cuda.device(self.device)
                     if self.device.type == "cuda"
                     else contextlib.nullcontext())
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._ctx.__exit__(*exc)


def make_host_mesh(device=None) -> HostMesh:
    """A one-device mesh on ``device`` (None: the card, which raises
    without one; pass ``device="cpu"`` for the CPU)."""
    return HostMesh(resolve_device(device))
