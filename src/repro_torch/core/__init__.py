"""AIReSim core on PyTorch: the CTMC replication path of the simulator.

Counterpart of ``src/repro/core`` for this slice of the port:

  * :mod:`params`        — the Params data class (all §III-B inputs)
  * :mod:`histograms`    — streaming distribution telemetry
  * :mod:`faultdomains`  — fault-domain / campaign parameter types
  * :mod:`metrics`       — RunResult + cross-replication statistics
  * :mod:`hazards`       — host-side hazard helpers (exponential family)
  * :mod:`analytical`    — closed-form cross-checks + Young/Daly cadence
  * :mod:`vectorized`    — the PyTorch CTMC engine (CUDA event race)
  * :mod:`backend`       — engine dispatch (ctmc; refusals for the rest)
  * :mod:`sweeps`        — OneWaySweep / TwoWaySweep experiment harness
"""

from .analytical import (CheckpointPlan, cluster_failure_rate,
                         expected_failures, expected_total_time,
                         plan_checkpoints, repair_shop_occupancy,
                         spare_capacity_bound, young_daly_interval)
from .backend import (ENGINES, Replications, resolve_engine, run_replications,
                      run_replications_batch)
from .faultdomains import Campaign, CampaignEvent, FaultTopology
from .hazards import hazard_kind
from .histograms import (HIST_CHANNELS, Histogram, HistogramSpec,
                         percentiles_per_row)
from .metrics import RunResult, Stat, aggregate_arrays, histograms_from_arrays
from .params import (MINUTES_PER_DAY, PAPER_TABLE1_RANGES, Params,
                     paper_table1_defaults)
from .sweeps import (DEFAULT_STATS, OneWaySweep, SweepPoint, SweepResult,
                     TwoWaySweep)
from .vectorized import (resolve_device, simulate_ctmc, simulate_ctmc_sweep,
                         supports, unsupported_reasons)

__all__ = [
    "Campaign", "CampaignEvent", "CheckpointPlan", "DEFAULT_STATS",
    "ENGINES", "FaultTopology", "HIST_CHANNELS", "Histogram",
    "HistogramSpec", "MINUTES_PER_DAY", "OneWaySweep", "PAPER_TABLE1_RANGES",
    "Params", "Replications", "RunResult", "Stat", "SweepPoint",
    "SweepResult", "TwoWaySweep", "aggregate_arrays", "cluster_failure_rate",
    "expected_failures", "expected_total_time", "hazard_kind",
    "histograms_from_arrays", "paper_table1_defaults", "percentiles_per_row",
    "plan_checkpoints", "repair_shop_occupancy", "resolve_device",
    "resolve_engine", "run_replications", "run_replications_batch",
    "simulate_ctmc", "simulate_ctmc_sweep", "spare_capacity_bound",
    "supports", "unsupported_reasons", "young_daly_interval",
]
