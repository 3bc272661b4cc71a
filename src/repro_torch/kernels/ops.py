"""Kernel dispatch of the port: the device picks the kernel or its plain version.

Counterpart of ``src/repro/kernels/ops.py`` (its ``event_race`` part).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import des_step, ref

#: accepted ``impl`` values of :func:`event_race`
EVENT_RACE_IMPLS = (None, "ref", "cuda")


def event_race(rates: torch.Tensor, residuals: torch.Tensor,
               u_time: torch.Tensor, u_pick: torch.Tensor, *,
               impl: Optional[str] = None,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-event race; see ``csrc/event_race.cu`` for what it computes.

    ``impl``: ``None`` chooses by the tensors' device -- the CUDA kernel
    for CUDA tensors, :func:`ref.event_race_ref` for CPU tensors.
    ``"ref"`` forces the plain version on any device; ``"cuda"`` forces
    the kernel and raises for CPU tensors.  On a CUDA tensor the kernel
    launches or raises: there is no fallback to the plain version.
    Zero-width lane blocks are refused on every path.

    With all rates zero the deterministic side wins and the event index
    is ``K_exp + argmin(residuals)``:

    >>> rates = torch.zeros((1, 2))
    >>> resid = torch.tensor([[3.0, 1.5]])
    >>> u = torch.tensor([0.5])
    >>> dt, ev = event_race(rates, resid, u, u)
    >>> float(dt[0]), int(ev[0])
    (1.5, 3)
    """
    if impl not in EVENT_RACE_IMPLS:
        raise ValueError(f"event_race impl={impl!r} must be None, 'ref' or "
                         "'cuda'")
    k_exp, k_det = rates.shape[-1], residuals.shape[-1]
    if k_exp == 0 or k_det == 0:
        raise ValueError(
            f"event_race needs at least one exponential and one "
            f"deterministic lane (got K_exp={k_exp}, K_det={k_det}); a "
            f"zero-width lane block has no next event to race -- disable "
            f"the empty side with zero rates / +inf residuals instead")
    on_cuda = rates.device.type == "cuda"
    if impl == "cuda" and not on_cuda:
        raise ValueError(
            f"event_race impl='cuda' needs CUDA tensors (got tensors on "
            f"{rates.device}); use impl='ref' or impl=None for the plain "
            f"PyTorch version on the CPU")
    if impl == "ref" or not on_cuda:
        return ref.event_race_ref(rates, residuals, u_time, u_pick)
    return des_step.event_race_cuda(rates, residuals, u_time, u_pick)
