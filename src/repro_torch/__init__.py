"""AIReSim on PyTorch and CUDA: the port of the JAX package ``repro``.

The JAX package stays the reference; this package mirrors its layout
(``core``, ``kernels``, ``models``, ``configs``, ``csrc``) and imports
neither JAX nor ``repro``.  It runs the single-job CTMC replication path
(every failure and repair family of the reference's, and fault domains
and campaigns) -- ``run_replications``, ``run_replications_batch``,
``OneWaySweep``, ``TwoWaySweep`` -- with each chunk of steps, event race
included, in one hand-written CUDA kernel (``csrc/ctmc_chunk.cu``); the
multi-job CTMC path (several jobs sharing one spare pool and one finite
repair shop) -- ``run_replications_multijob``, ``run_multijob_batch``,
``MultiJobSweep`` -- with each step's race in the standalone race kernel
(``csrc/event_race.cu``); and serves decoder-only
LMs (``repro_torch.models.build_model``: prefill and greedy decode) with
attention and the Mamba scan in hand-written CUDA kernels
(``csrc/flash_attention.cu``, ``csrc/mamba_scan.cu``), on an NVIDIA H100.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from .core import (JobSpec, MultiJobReplications, MultiJobSweep,
                   OneWaySweep, Params, Replications, SweepResult,
                   TwoWaySweep, run_multijob_batch, run_replications,
                   run_replications_batch, run_replications_multijob,
                   simulate_ctmc, simulate_ctmc_sweep,
                   simulate_multijob_ctmc, simulate_multijob_ctmc_sweep)

__all__ = ["JobSpec", "MultiJobReplications", "MultiJobSweep",
           "OneWaySweep", "Params", "Replications", "SweepResult",
           "TwoWaySweep", "run_multijob_batch", "run_replications",
           "run_replications_batch", "run_replications_multijob",
           "simulate_ctmc", "simulate_ctmc_sweep", "simulate_multijob_ctmc",
           "simulate_multijob_ctmc_sweep"]
