"""End-to-end driver: train a language model under injected failures, on
the PyTorch/CUDA port.

The port's copy of ``examples/train_with_failures.py``: the same presets,
cluster and loop, on ``repro_torch``'s one-device train step (the card by
default; ``--device cpu`` for the CPU), and the same last part through the
port's ``simulate``.

This closes the paper's loop in one script:
  1. pick a cluster reliability configuration (AIReSim Params);
  2. derive the checkpoint cadence from Young/Daly on those failure rates;
  3. train a real model with the fault-tolerant loop — failures are
     injected from the SAME exponential model, recovery restores the
     latest checkpoint and reseeks the data pipeline;
  4. compare the measured overhead fraction against what the AIReSim
     simulator predicts for this configuration.

Default preset is laptop-sized so the demo finishes on one CPU core;
``--preset 100m`` is the full-size variant for real hardware
(d_model=768, 12 layers, ~100M params, a few hundred steps).

    PYTHONPATH=src python examples/torch_train_with_failures.py \
        [--steps 60] [--device cpu]
"""

import argparse
import os
import tempfile

import numpy as np

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import MINUTES_PER_DAY, Params, simulate
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.train.loop import TrainLoopConfig, train
from repro_torch.train.optimizer import OptimizerConfig

PRESETS = {
    "tiny": (ModelConfig(name="tiny-lm", family="dense", n_layers=4,
                         d_model=128, n_heads=4, n_kv_heads=2, d_ff=512,
                         vocab_size=2048, dtype="float32"),
             ShapeSpec("tiny", 64, 4, "train")),
    "100m": (ModelConfig(name="lm-100m", family="dense", n_layers=12,
                         d_model=768, n_heads=12, n_kv_heads=4, d_ff=3072,
                         vocab_size=32768, dtype="float32"),
             ShapeSpec("train", 512, 8, "train")),
}

parser = argparse.ArgumentParser()
parser.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
parser.add_argument("--steps", type=int, default=60)
parser.add_argument("--ckpt-dir", default=os.path.join(
    tempfile.gettempdir(), "repro_torch_example_ckpt"))
parser.add_argument("--device", default=None,
                    help="cpu for the CPU (default: the card)")
args = parser.parse_args()

cfg, shape = PRESETS[args.preset]
print(f"model: {cfg.name} ({cfg.param_count() / 1e6:.1f}M params), "
      f"{args.steps} steps of batch {shape.global_batch} x {shape.seq_len}")

# a cluster where failures are frequent enough to see during the demo:
# ~1 failure per 15 simulated step-minutes
cluster = Params(job_size=64, working_pool_size=72, spare_pool_size=8,
                 warm_standbys=4,
                 random_failure_rate=1.0 / MINUTES_PER_DAY,
                 systematic_failure_rate=5.0 / MINUTES_PER_DAY,
                 job_length=args.steps * 1.0)

bundle = build_model(cfg, device=args.device)
mesh = make_host_mesh(device=args.device)
out = train(
    bundle, mesh, shape,
    TrainLoopConfig(total_steps=args.steps, log_every=max(args.steps // 6, 1),
                    checkpoint_dir=args.ckpt_dir,
                    checkpoint_cost_minutes=0.5, step_minutes=1.0,
                    inject_failures=True, cluster=cluster, seed=0),
    OptimizerConfig(learning_rate=3e-3, warmup_steps=max(args.steps // 10, 1),
                    total_steps=args.steps, min_lr_fraction=0.5),
)

print("\n--- training history ---")
for h in out["history"]:
    print(f"  step {h['step']:4d}  loss {h['loss']:7.4f}  "
          f"lr {h['lr']:.2e}  {h['step_time_s'] * 1e3:7.1f} ms/step")
print(f"\ncheckpoint cadence (Young/Daly): every "
      f"{out['checkpoint_cadence']} steps")
print(f"recovery events: {out['recovery']}")

# synthetic tokens are uniform -> the achievable floor is ln(vocab); check
# the model moved toward it despite the failures
first, last = out["history"][0]["loss"], out["history"][-1]["loss"]
floor = float(np.log(cfg.vocab_size))
assert last < first - 0.01, (
    f"training did not reduce the loss ({first:.3f} -> {last:.3f}; "
    f"uniform-token floor is {floor:.3f})")
print(f"loss: {first:.3f} -> {last:.3f} (floor ~{floor:.2f}) OK despite "
      f"{out['recovery']['n_failures']} failure(s)")

# --- what does AIReSim predict for this cluster? -------------------------
# the injector draws from the same exponential model the simulator sweeps,
# so the FAILURE COUNT over the job is directly comparable
pred = simulate(cluster, n_replications=10)
sim_failures = float(np.mean([r.n_failures for r in pred]))
print(f"\nAIReSim-predicted failures over the job: {sim_failures:5.1f}")
print(f"failures injected into this training run: "
      f"{out['recovery']['n_failures']:5d}")
print(f"AIReSim-predicted overhead fraction (incl. 20-min recoveries): "
      f"{np.mean([r.overhead_fraction for r in pred]):.3f} — the capacity "
      f"planner's input for this cluster")
