#!/usr/bin/env python
"""Fit a piecewise-constant hazard from a failure/repair event log (port).

Counterpart of ``scripts/fit_hazard.py`` on the PyTorch port: the same
arguments and the same fit JSON.  Turns a timestamped CSV/JSONL event log
(or an explicit duration column) into the segment ``edges``/``rates``
JSON that ``Params(failure_distribution="empirical",
distribution_kwargs=fit.distribution_kwargs)`` consumes on the port's
CTMC path -- see docs/distributions.md for the log format and
:mod:`repro_torch.core.empirical` for the estimators.

    python scripts/torch_fit_hazard.py failures.csv                # fit -> stdout
    python scripts/torch_fit_hazard.py failures.csv -o fit.json    # fit -> file
    python scripts/torch_fit_hazard.py log.jsonl --event failure --bins 6
    python scripts/torch_fit_hazard.py --selftest                  # on the card
    python scripts/torch_fit_hazard.py --selftest --device cpu

``--selftest`` generates a synthetic log, fits it, round-trips the fit
through JSON, runs a short CTMC study from the fitted hazard on
``--device`` (default the card, where it runs the chunk kernel's
empirical instance; ``cpu`` must be asked for), and exits non-zero on
any mismatch.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.core import (Params, resolve_engine,  # noqa: E402
                              run_replications)
from repro_torch.core.empirical import (PiecewiseFit,  # noqa: E402
                                        fit_piecewise_hazard, from_log)


def _fit_from_args(args: argparse.Namespace) -> PiecewiseFit:
    durations = from_log(args.log, event=args.event,
                         time_field=args.time_field,
                         duration_field=args.duration_field,
                         entity_field=args.entity)
    return fit_piecewise_hazard(durations, n_bins=args.bins,
                                method=args.method)


def _check(ok: bool, msg: str) -> None:
    """The selftest's checks, which hold under ``python -O`` too."""
    if not ok:
        raise AssertionError(msg)


def selftest(device=None) -> int:
    """Synthetic log -> fit -> JSON round trip -> short CTMC run on
    ``device`` (default the card)."""
    import numpy as np

    rng = np.random.default_rng(7)
    # two-regime synthetic fleet: early failures at 1/40 min, then 1/400
    rows = []
    for server in range(40):
        t = 0.0
        for k in range(6):
            t += float(rng.exponential(40.0 if k < 2 else 400.0))
            rows.append((t, server))
    with tempfile.TemporaryDirectory() as td:
        log = Path(td) / "failures.csv"
        with log.open("w") as fh:
            fh.write("time,server\n")
            for t, server in sorted(rows):
                fh.write(f"{t:.4f},{server}\n")
        fit = fit_piecewise_hazard(from_log(log), n_bins=4)
    blob = json.loads(json.dumps(fit.to_json()))   # the full disk round trip
    rt = PiecewiseFit.from_json(blob)
    _check(rt.edges == fit.edges and rt.rates == fit.rates,
           "JSON round trip changed the fit")
    _check(0 < fit.mean < 1e6 and fit.rate > 0, f"bad fit mean {fit.mean}")

    p = Params(job_size=16, working_pool_size=24, spare_pool_size=4,
               warm_standbys=2, job_length=600.0,
               random_failure_rate=fit.rate,
               systematic_failure_rate=2.0 * fit.rate,
               failure_distribution="empirical",
               distribution_kwargs=fit.distribution_kwargs,
               histogram=None)
    engine = resolve_engine(p, "auto")
    _check(engine == "ctmc", f"fitted hazard routed to {engine}, not ctmc")
    rep = run_replications(p, 64, engine="ctmc", device=device)
    tt = rep.stats["total_time"].mean
    _check(tt > p.job_length, f"implausible total_time {tt}")
    print(f"fit_hazard selftest OK: {len(fit.rates)} segments, "
          f"mean={fit.mean:.1f} min, ctmc total_time={tt:.1f} min")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("log", nargs="?", help="CSV/JSONL event log")
    ap.add_argument("-o", "--out", help="write fit JSON here (default stdout)")
    ap.add_argument("--event", default=None,
                    help="keep only rows whose event/kind field equals this")
    ap.add_argument("--time-field", default="time")
    ap.add_argument("--duration-field", default="duration")
    ap.add_argument("--entity", default=None,
                    help="per-entity column for interarrival extraction "
                         "(auto-detected among server/host/node/entity/id)")
    ap.add_argument("--bins", type=int, default=8,
                    help="number of hazard segments to fit (default 8)")
    ap.add_argument("--method", default="nelson-aalen",
                    choices=("nelson-aalen", "binned"))
    ap.add_argument("--selftest", action="store_true",
                    help="run the synthetic round-trip smoke and exit")
    ap.add_argument("--device", default=None,
                    help="the selftest's run device (default the card; "
                         "'cpu' must be asked for)")
    args = ap.parse_args(argv)

    if args.selftest:
        return selftest(args.device)
    if not args.log:
        ap.error("an event log is required (or --selftest)")
    fit = _fit_from_args(args)
    blob = json.dumps(fit.to_json(), indent=2)
    if args.out:
        Path(args.out).write_text(blob + "\n")
        print(f"wrote {args.out}: {len(fit.rates)} segments, "
              f"mean={fit.mean:.2f}, rate={fit.rate:.6g}", file=sys.stderr)
    else:
        print(blob)
    return 0


if __name__ == "__main__":
    sys.exit(main())
