"""Plain PyTorch versions of the port's kernels.

The CPU path of every kernel wrapper, and the yardstick the hand-written
CUDA kernels are held against on the card.  Counterpart of
``src/repro/kernels/ref.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def event_race_ref(rates: torch.Tensor, residuals: torch.Tensor,
                   u_time: torch.Tensor, u_pick: torch.Tensor,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Race K_exp exponential clocks against K_det deterministic timers.

    rates:     (R, K_exp) propensities (0 = clock off)
    residuals: (R, K_det) remaining deterministic times (+inf = off)
    u_time, u_pick: (R,) uniforms in (0, 1)

    Returns ``(dt (R,) float32, event (R,) int32)``: ``event < K_exp``
    indexes the winning exponential family (inverse-CDF pick of
    ``u_pick`` over the rate cumsum; ties ``t_exp <= t_det`` go to the
    exponential side), ``event >= K_exp`` is ``K_exp + argmin`` of the
    residuals (first lane on ties; an all-+inf row gives lane 0).

    The sum and the cumsum run lane by lane in order, so the result is
    the same on every device and matches the CUDA kernel
    (``csrc/event_race.cu``) bit for bit in the pick.

    >>> rates = torch.zeros((1, 2))
    >>> resid = torch.tensor([[3.0, 1.5]])
    >>> u = torch.tensor([0.5])
    >>> dt, ev = event_race_ref(rates, resid, u, u)
    >>> float(dt[0]), int(ev[0])
    (1.5, 3)
    """
    k_exp = rates.shape[-1]
    cum = []
    acc = rates[:, 0]
    cum.append(acc)
    for j in range(1, k_exp):
        acc = acc + rates[:, j]
        cum.append(acc)
    total = acc
    safe_total = total.clamp_min(1e-30)
    t_exp = -torch.log(u_time) / safe_total
    t_exp = torch.where(total > 0, t_exp, torch.inf)

    cdf = torch.stack(cum, dim=-1) / safe_total[:, None]
    pick_exp = (u_pick[:, None] >= cdf).sum(-1)
    pick_exp = pick_exp.clamp_max(k_exp - 1).to(torch.int32)

    t_det, arg = residuals.min(-1)
    pick_det = arg.to(torch.int32) + k_exp

    dt = torch.minimum(t_exp, t_det)
    event = torch.where(t_exp <= t_det, pick_exp, pick_det)
    return dt, event
