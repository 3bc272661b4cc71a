"""Named variants over the dry-run cells.

Counterpart of ``src/repro/launch/perf.py``.  Each variant traces a cell
again with a configuration change (sharding knob, remat policy, MoE
buffer layout, optimizer dtype) and reports the three roofline terms next
to the baseline, into results/torch/perf.json.  The baseline takes the
mesh steps' sequence parallelism (the activation between sublayers
sharded along the sequence over "model", all-gathered into each
sublayer and reduce-scattered out of it); ``no_sp`` traces the cell with
``shard_sequence=False``: the activation whole over "model", the
sublayers' partials all-reduced.  Every record carries the
'kernelized' terms too: the traced terms with the CUDA kernels' own
traffic in place of the plain attention and scan
(``roofline.kernel_adjust``).  Like the dry run it allocates nothing and
needs no card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.perf --arch falcon-mamba-7b \\
      --shape train_4k --variant baseline,remat_dots
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, Optional, Sequence

from ..configs import SHAPES, get_config
from ..parallel import ParallelConfig
from ..roofline.kernel_adjust import kernelized_roofline
from .dryrun import opt_config_for, trace_cell

#: variant name -> dict of overrides:
#:   pcfg: ParallelConfig field overrides
#:   model: ModelConfig field overrides (remat policy, capacity factor...)
#:   opt_state_dtype: Adam moment dtype
VARIANTS: Dict[str, Dict] = {
    "baseline": {},
    "no_sp": {"pcfg": {"shard_sequence": False}},
    "remat_dots": {"model": {"remat_policy": "dots"}},
    "no_remat": {"model": {"remat_policy": "full"}},
    "moe_dp_buffer": {"pcfg": {"moe_buffer_mode": "dp"}},
    "moe_ep_buffer": {"pcfg": {"moe_buffer_mode": "ep"}},
    "moe_token_local": {"pcfg": {"moe_buffer_mode": "ep_local"}},
    "moe_token_local_cap1": {"pcfg": {"moe_buffer_mode": "ep_local"},
                             "model": {"capacity_factor": 1.0}},
    "moe_none_buffer": {"pcfg": {"moe_buffer_mode": "none"}},
    "moe_shard_map": {"pcfg": {"moe_buffer_mode": "shard_map"}},
    "moe_shard_map_cap1": {"pcfg": {"moe_buffer_mode": "shard_map"},
                           "model": {"capacity_factor": 1.0}},
    "no_vocab_shard": {"pcfg": {"shard_embed_vocab": False}},
    "opt_bf16": {"opt_state_dtype": "bfloat16"},
    "capacity_1_0": {"model": {"capacity_factor": 1.0}},
}


def run_variant(arch: str, shape_name: str, variant: str,
                multi_pod: bool = False) -> Dict:
    """The record of ``variant`` on the cell: its traced roofline and its
    kernelized terms."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; known: "
                         f"{sorted(VARIANTS)}")
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    spec = VARIANTS[variant]
    if spec.get("model"):
        cfg = cfg.replace(**spec["model"])
    pcfg = ParallelConfig(**spec.get("pcfg", {}))
    opt_cfg = opt_config_for(cfg)
    if spec.get("opt_state_dtype"):
        opt_cfg = dataclasses.replace(opt_cfg,
                                      state_dtype=spec["opt_state_dtype"])
    mesh_name = "2x16x16" if multi_pod else "16x16"
    fields, roof = trace_cell(cfg, shape, mesh_name, pcfg, opt_cfg)
    rec = {"arch": arch, "shape": shape_name, "variant": variant,
           "mesh": mesh_name, "trace_s": fields["trace_s"],
           "per_device_resident_gb": fields["per_device_resident_gb"],
           "roofline": roof.to_dict()}
    rec["kernelized"] = kernelized_roofline(roof, cfg, shape)
    return rec


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="results/torch/perf.json")
    args = ap.parse_args(argv)

    records = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            records = json.load(f)

    for variant in args.variant.split(","):
        rec = run_variant(args.arch, args.shape, variant, args.multi_pod)
        r = rec["roofline"]
        k = rec["kernelized"]
        print(f"[perf] {args.arch} x {args.shape} [{variant}]: "
              f"c/m/x = {r['compute_s']:.3f}/{r['memory_s']:.3f}/"
              f"{r['collective_s']:.3f}s frac={r['roofline_fraction']:.3f} "
              f"resident={rec['per_device_resident_gb']:.1f}GB | kernelized "
              f"m={k['memory_s']:.3f}s frac={k['roofline_fraction']:.3f}")
        records = [x for x in records if not (
            x["arch"] == args.arch and x["shape"] == args.shape
            and x["variant"] == variant and x["mesh"] == rec["mesh"])]
        records.append(rec)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)


if __name__ == "__main__":
    main()
