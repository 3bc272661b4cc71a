"""Training launcher CLI: arch + shape -> fault-tolerant loop.

Counterpart of ``src/repro/launch/train.py``, with ``--device`` beside the
reference's flags (the port runs on the card unless told otherwise):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --smoke --steps 50 --inject-failures [--device cpu]

``--smoke`` runs the reduced same-family config on ``make_host_mesh()``
(one device, or the ranks of a process group a launcher such as
``torchrun`` started: its ``WORLD_SIZE`` / ``RANK`` / ``MASTER_ADDR``
environment initialises one).  Without it the full config runs on the
production mesh, which needs a process group of its size (256 ranks, or
512 with ``--multi-pod``) and refuses, naming both counts, without one.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core.params import Params as ClusterParams
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import build_model
from repro_torch.train.loop import TrainLoopConfig, train
from repro_torch.train.optimizer import OptimizerConfig


def _init_from_env(device) -> None:
    """Join the process group a launcher described in the environment."""
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        dist.init_process_group(
            "nccl" if resolve_device(device).type == "cuda" else "gloo")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config on the host mesh")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="default: Young/Daly cadence from --cluster-* rates")
    ap.add_argument("--inject-failures", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None, help="write run summary JSON")
    ap.add_argument("--device", default=None,
                    help="cpu for the CPU (default: the card)")
    args = ap.parse_args(argv)

    _init_from_env(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.smoke:
        mesh = make_host_mesh(args.device)
        shape = ShapeSpec("cli", args.seq_len or 64, args.global_batch or 4,
                          "train")
    else:
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device=args.device)
        shape = ShapeSpec("cli", args.seq_len or 4096,
                          args.global_batch or 256, "train")

    bundle = build_model(cfg, device=mesh.device)
    out = train(
        bundle, mesh, shape,
        TrainLoopConfig(total_steps=args.steps,
                        log_every=max(args.steps // 10, 1),
                        checkpoint_dir=args.ckpt_dir,
                        checkpoint_every=args.ckpt_every,
                        inject_failures=args.inject_failures,
                        cluster=ClusterParams()),
        OptimizerConfig(learning_rate=args.lr,
                        warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps),
    )
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    for h in out["history"]:
        print(f"step {h['step']:5d}  loss {h['loss']:8.4f}  "
              f"{h['step_time_s'] * 1e3:8.1f} ms")
    print(f"done: {out['steps']} steps, final loss {out['final_loss']:.4f}, "
          f"recoveries {out['recovery']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=float)


if __name__ == "__main__":
    main()
