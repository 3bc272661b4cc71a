"""Host-side hazard helpers of the CTMC engine, exponential family only.

Counterpart of the host half of ``src/repro/core/hazards.py``.  The
port's engine runs the paper's exponential failures and repairs; the
Weibull, bathtub, lognormal, empirical and deterministic families are
ROADMAP queue 1 items 7-8.  Here every non-exponential family maps to
``None`` -- "not on the port's fast path" -- which
:func:`repro_torch.core.vectorized.unsupported_reasons` turns into a
refusal that names the roadmap item.  The column layout keeps the
reference's widths, so the parameter vectors line up column for column.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .params import Params

#: failure-distribution families of the reference's fast path
HAZARD_KINDS = ("exponential", "weibull", "bathtub", "lognormal",
                "empirical")

#: repair-distribution families of the reference's fast path
REPAIR_KINDS = ("exponential", "weibull", "lognormal", "deterministic",
                "empirical")

#: hazard parameter columns after the 16 base columns (all zero and
#: unused for the exponential family)
N_HAZARD_COLS = 5

#: repair parameter columns after the hazard columns (all zero and
#: unused for exponential repairs)
N_REPAIR_COLS = 3


def hazard_col_count(kind: Optional[str], n_segments: int = 0) -> int:
    """Width of the hazard-column block for this family.

    >>> hazard_col_count("exponential")
    5
    >>> hazard_col_count("empirical", 4)
    14
    """
    return 4 * n_segments - 2 if kind == "empirical" else N_HAZARD_COLS


def repair_col_count(kind: Optional[str], n_segments: int = 0) -> int:
    """Width of the repair-column block for this family."""
    return 4 * n_segments - 2 if kind == "empirical" else N_REPAIR_COLS


def hazard_kind(params: Params) -> Optional[str]:
    """``"exponential"`` for the paper's failure model, else None.

    >>> hazard_kind(Params())
    'exponential'
    >>> hazard_kind(Params(failure_distribution="weibull")) is None
    True
    """
    if params.failure_distribution.lower() == "exponential":
        return "exponential"
    return None


def repair_kind(params: Params) -> Optional[str]:
    """``"exponential"`` for the paper's repair model, else None."""
    if params.repair_distribution.lower() == "exponential":
        return "exponential"
    return None


def hazard_segment_count(params: Params) -> int:
    """Segment count of an empirical failure hazard: 0 on this path."""
    return 0


def repair_segment_count(params: Params) -> int:
    """Segment count of an empirical repair family: 0 on this path."""
    return 0


def hazard_columns(params: Params) -> np.ndarray:
    """Failure-hazard parameter columns: ``N_HAZARD_COLS`` zeros."""
    return np.zeros(N_HAZARD_COLS, np.float32)


def repair_columns(params: Params) -> np.ndarray:
    """Repair parameter columns: ``N_REPAIR_COLS`` zeros."""
    return np.zeros(N_REPAIR_COLS, np.float32)


def effective_event_rate(params: Params) -> float:
    """Cluster failure-event rate for step budgeting: the paper's
    ``expected_failures_per_minute`` under exponential failures."""
    return params.expected_failures_per_minute()


def phantom_steps(params: Params) -> int:
    """Thinning phantom steps to budget: none for exponential hazards."""
    return 0
