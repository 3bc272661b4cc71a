"""AIReSim on PyTorch and CUDA: the port of the JAX package ``repro``.

The JAX package stays the reference; this package mirrors its layout
(``core``, ``kernels``, ``csrc``) and imports neither JAX nor ``repro``.
This slice runs the exponential single-job CTMC replication path --
``run_replications``, ``run_replications_batch``, ``OneWaySweep``,
``TwoWaySweep`` -- on an NVIDIA H100, with the next-event race in a
hand-written CUDA kernel (``csrc/event_race.cu``).  Entry points run on
the card unless the caller passes ``device="cpu"``.
"""

from .core import (OneWaySweep, Params, Replications, SweepResult,
                   TwoWaySweep, run_replications, run_replications_batch,
                   simulate_ctmc, simulate_ctmc_sweep)

__all__ = ["OneWaySweep", "Params", "Replications", "SweepResult",
           "TwoWaySweep", "run_replications", "run_replications_batch",
           "simulate_ctmc", "simulate_ctmc_sweep"]
