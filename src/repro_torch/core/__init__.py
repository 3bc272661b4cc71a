"""AIReSim core on PyTorch: both engines of the simulator.

Counterpart of ``src/repro/core``:

  * :mod:`engine`        — generator-coroutine DES engine (SimPy-equivalent)
  * :mod:`params`        — the Params data class (all §III-B inputs)
  * :mod:`distributions` — failure / repair distributions and their registry
    (:mod:`bathtub` and :mod:`empirical` register their families)
  * :mod:`server`        — fleet, per-server state, analytical failure sampler
  * :mod:`coordinator`   — job execution loop / failure broadcast
  * :mod:`scheduler`     — host selection, warm standbys, stall handling
  * :mod:`repair`        — diagnosis -> auto -> manual repair -> retire/return
  * :mod:`pool`          — working / spare pool bookkeeping
  * :mod:`simulation`    — one event-engine replication; ``simulate``
  * :mod:`multijob`      — the event engine for several jobs on one fleet
  * :mod:`trace`         — optional event-trace recorder
  * :mod:`histograms`    — streaming distribution telemetry
  * :mod:`faultdomains`  — fault-domain / campaign types, shock injector
  * :mod:`metrics`       — RunResult + cross-replication statistics
  * :mod:`hazards`       — host-side hazard classifier and column helpers
  * :mod:`analytical`    — closed-form cross-checks + Young/Daly cadence
  * :mod:`vectorized`    — the PyTorch CTMC engine (CUDA chunk kernel)
  * :mod:`vectorized_multijob` — the PyTorch multi-job CTMC engine (shared
    spare pool, finite repair shop; CUDA event-race kernel)
  * :mod:`backend`       — engine dispatch (auto | event | ctmc), single-
    and multi-job
  * :mod:`optimize`      — goodput-maximizing knob search
  * :mod:`sweeps`        — OneWaySweep / TwoWaySweep / MultiJobSweep
    experiment harness, ``load_experiment``
"""

from . import bathtub as _bathtub  # noqa: F401  (registers "bathtub" dist)
from .analytical import (CheckpointPlan, cluster_failure_rate,
                         expected_failures, expected_total_time,
                         plan_checkpoints, repair_shop_occupancy,
                         spare_capacity_bound, young_daly_interval)
from .backend import (ENGINES, MultiJobReplications, Replications,
                      resolve_engine, resolve_engine_multijob,
                      run_multijob_batch, run_replications,
                      run_replications_batch, run_replications_multijob)
from .bathtub import Bathtub
from .distributions import (Deterministic, Distribution, Exponential,
                            LogNormal, Weibull, make_distribution,
                            register_distribution)
from .empirical import (Empirical, PiecewiseFit, fit_piecewise_hazard,
                        from_log, from_mttf_table)
from .engine import Environment, Event, Interrupt, Process, Timeout
from .faultdomains import (Campaign, CampaignEvent, FaultTopology,
                           ShockInjector)
from .hazards import hazard_kind
from .histograms import (HIST_CHANNELS, Histogram, HistogramSpec,
                         percentiles_per_row)
from .metrics import (RunResult, Stat, aggregate, aggregate_arrays,
                      aggregate_multijob_arrays, histograms_from_arrays,
                      histograms_from_results, pool_histograms, summarize)
from .multijob import (JobSpec, MultiJobResult, MultiJobSimulation,
                       simulate_multijob)
from .optimize import (CheckpointOptResult, KnobOptResult,
                       optimize_checkpoint_interval, optimize_knobs)
from .params import (MINUTES_PER_DAY, PAPER_TABLE1_RANGES, Params,
                     paper_table1_defaults)
from .simulation import ClusterSimulation, simulate, simulate_one
from .sweeps import (DEFAULT_STATS, MultiJobSweep, OneWaySweep, SweepPoint,
                     SweepResult, TwoWaySweep, load_experiment)
from .trace import TraceEvent, Tracer
from .vectorized import (resolve_device, simulate_ctmc, simulate_ctmc_sweep,
                         supports, unsupported_reasons)
from .vectorized_multijob import (simulate_multijob_ctmc,
                                  simulate_multijob_ctmc_sweep,
                                  supports_multijob)

__all__ = [
    "Bathtub", "Campaign", "CampaignEvent", "CheckpointOptResult",
    "CheckpointPlan", "ClusterSimulation", "DEFAULT_STATS", "Deterministic",
    "Distribution", "ENGINES", "Empirical", "Environment", "Event",
    "Exponential", "FaultTopology", "HIST_CHANNELS", "Histogram",
    "HistogramSpec", "Interrupt", "JobSpec", "KnobOptResult", "LogNormal",
    "MINUTES_PER_DAY", "MultiJobReplications", "MultiJobResult",
    "MultiJobSimulation", "MultiJobSweep", "OneWaySweep", "PAPER_TABLE1_RANGES", "Params", "PiecewiseFit",
    "Process", "Replications", "RunResult", "ShockInjector", "Stat",
    "SweepPoint", "SweepResult", "Timeout", "TraceEvent", "Tracer",
    "TwoWaySweep", "Weibull", "aggregate", "aggregate_arrays",
    "aggregate_multijob_arrays",
    "cluster_failure_rate", "expected_failures", "expected_total_time",
    "fit_piecewise_hazard", "from_log", "from_mttf_table", "hazard_kind",
    "histograms_from_arrays", "histograms_from_results", "load_experiment",
    "make_distribution", "optimize_checkpoint_interval", "optimize_knobs",
    "paper_table1_defaults", "percentiles_per_row", "plan_checkpoints",
    "pool_histograms",
    "register_distribution", "repair_shop_occupancy", "resolve_device",
    "resolve_engine", "resolve_engine_multijob", "run_multijob_batch",
    "run_replications", "run_replications_batch",
    "run_replications_multijob", "simulate", "simulate_multijob",
    "simulate_multijob_ctmc", "simulate_multijob_ctmc_sweep",
    "simulate_one", "simulate_ctmc", "simulate_ctmc_sweep",
    "spare_capacity_bound", "summarize", "supports", "supports_multijob",
    "unsupported_reasons", "young_daly_interval",
]
