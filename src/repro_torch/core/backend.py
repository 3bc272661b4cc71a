"""Engine dispatch: route replication studies to the port's CTMC engine.

Counterpart of ``src/repro/core/backend.py`` (its single-job part).  The
reference has two engines; this slice of the port has one, the
vectorized CTMC engine (:mod:`repro_torch.core.vectorized`).  The event
engine is not ported yet (ROADMAP queue 1 item 5), so where the
reference's ``engine="auto"`` would fall back to it, the port refuses
loudly with the reasons the CTMC engine gives -- it never degrades to a
different model quietly.

Every entry point takes ``device=`` (default: the card; the CPU only
when the caller passes ``device="cpu"``).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from . import vectorized
from .histograms import Histogram
from .metrics import RunResult, Stat, aggregate_arrays, histograms_from_arrays
from .params import Params

ENGINES = ("auto", "event", "ctmc")


def resolve_engine(params: Params, engine: str = "auto") -> str:
    """Map an engine request to the engine that will run: always ``ctmc``.

    Raises when the params are outside the port's CTMC engine (with its
    reasons) and for ``engine="event"``, whose engine is not ported yet.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{ENGINES}")
    reasons = vectorized.unsupported_reasons(params)
    if engine == "event":
        reasons = ["the event engine is not yet ported to the PyTorch port "
                   "(ROADMAP queue 1 item 5)"] + reasons
    if reasons:
        raise ValueError(
            f"engine={engine!r} cannot run these Params on the PyTorch "
            "port: " + "; ".join(reasons)
            + "; the JAX reference package (repro.core) runs them")
    return "ctmc"


@dataclass
class Replications:
    """Aggregated outcome of one replication study (one sweep point)."""

    engine: str                     # concrete engine that ran: ctmc
    n: int                          # number of replications
    stats: Dict[str, Stat]
    #: per-replication RunResults (event engine only; empty for ctmc)
    results: List[RunResult] = field(default_factory=list)
    #: raw {metric: (n,) ndarray} (ctmc engine)
    arrays: Optional[Dict[str, np.ndarray]] = None
    #: pooled streaming histograms per channel (whenever
    #: ``Params.histogram`` is set)
    histograms: Dict[str, Histogram] = field(default_factory=dict)


def _from_arrays(arrays: Dict[str, np.ndarray], n: int) -> Replications:
    incomplete = int(n - arrays["completed"].sum())
    if incomplete:
        warnings.warn(
            f"{incomplete}/{n} CTMC replicas hit the step budget before "
            "finishing the job; means are biased low — raise max_steps "
            "(truncation is surfaced as the 'n_incomplete' metric and the "
            "'completed' fraction in stats and sweep CSVs)",
            RuntimeWarning, stacklevel=3)
    overflows = int(arrays.get("n_repair_overflow", np.zeros(1)).sum())
    if overflows:
        warnings.warn(
            f"{overflows} diagnosed failure(s) found the repair-slot lane "
            "full (the server never leaves the shop; results are biased) "
            "— raise Params.repair_slots",
            RuntimeWarning, stacklevel=3)
    hists = histograms_from_arrays(arrays)
    return Replications(engine="ctmc", n=n,
                        stats=aggregate_arrays(arrays, histograms=hists),
                        arrays=arrays, histograms=hists)


def run_replications(params: Params, n: int, engine: str = "auto",
                     base_seed: Optional[int] = None,
                     impl: Optional[str] = None,
                     max_steps: Optional[int] = None,
                     device=None) -> Replications:
    """Run ``n`` independent replications on the port's CTMC engine."""
    resolve_engine(params, engine)
    seed = params.seed if base_seed is None else base_seed
    arrays = vectorized.simulate_ctmc(params, n_replicas=n, seed=seed,
                                      impl=impl, max_steps=max_steps,
                                      device=device)
    return _from_arrays(arrays, n)


def run_replications_batch(params_list: Sequence[Params], n: int,
                           engine: str = "auto",
                           base_seed: Optional[int] = None,
                           impl: Optional[str] = None,
                           max_steps: Optional[int] = None,
                           progress: Optional[Callable[[int], None]] = None,
                           padded: bool = True,
                           bucketed: bool = True,
                           device=None) -> List[Replications]:
    """Replication studies for a whole sweep grid in one batched run.

    Every point runs in a single :func:`vectorized.simulate_ctmc_sweep`
    call (``padded`` / ``bucketed`` as there).  ``progress(i)`` is called
    for every point up front, since they all start together.  Results
    come back in input order.
    """
    params_list = list(params_list)
    for p in params_list:
        resolve_engine(p, engine)
    if not params_list:
        return []
    if progress:
        for i in range(len(params_list)):
            progress(i)
    seed = params_list[0].seed if base_seed is None else base_seed
    arrays_list = vectorized.simulate_ctmc_sweep(
        params_list, n_replicas=n, seed=seed, impl=impl, max_steps=max_steps,
        padded=padded, bucketed=bucketed, device=device)
    return [_from_arrays(arrays, n) for arrays in arrays_list]
