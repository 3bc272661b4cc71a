"""Fault-tolerant training loop.

Counterpart of ``src/repro/train/loop.py``: the same control flow (resume,
inject, restore and re-seek, straggler, cadence, final save) on the
port's train step, pipeline, checkpoints and fault tolerance.
The state is ``{"params": {name: tensor}, "opt": ...}`` on the mesh's
device; a restore reads the checkpoint to the host and moves it there.
On a mesh of ranks (``launch.mesh.RankMesh``) each rank holds its parts
of the state and the batch (the step's ``place``, by
``params_shardings`` and ``opt_state_shardings``); a checkpoint is the
gathered state, which rank 0 writes in the one-file format, and a
restore places it again.

Wires together: sharded train_step (parallel.steps), the seekable data
pipeline, async checkpointing, failure injection + restart, straggler
policy, and the Young/Daly checkpoint cadence computed from the SAME
cluster parameters the AIReSim sweeps use (core.analytical).

This is the end-to-end driver behind examples/train_with_failures.py and
launch/train.py.
"""

from __future__ import annotations

import math
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..configs.shapes import ShapeSpec
from ..core.analytical import plan_checkpoints
from ..core.params import Params as ClusterParams
from ..data.pipeline import DataConfig, SyntheticTokenPipeline
from ..launch.mesh import RankMesh
from ..models.model_zoo import ModelBundle
from ..parallel import sharding
from ..parallel.steps import BuiltStep, make_train_step
from .checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from .fault_tolerance import FailureInjector, RecoveryStats, StragglerPolicy
from .optimizer import OptimizerConfig, init_opt_state


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    log_every: int = 10
    checkpoint_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    checkpoint_every: Optional[int] = None   # None -> Young/Daly cadence
    checkpoint_cost_minutes: float = 1.0     # write cost fed to Young/Daly
    step_minutes: float = 1.0                # simulated minutes per step
    keep_checkpoints: int = 3
    seed: int = 0
    inject_failures: bool = False
    deterministic_failure_steps: Optional[List[int]] = None
    cluster: ClusterParams = field(default_factory=ClusterParams)


def checkpoint_cadence(cfg: TrainLoopConfig) -> int:
    """Steps between checkpoints (Young/Daly on the cluster params)."""
    if cfg.checkpoint_every is not None:
        return cfg.checkpoint_every
    plan = plan_checkpoints(cfg.cluster, cfg.checkpoint_cost_minutes)
    if math.isinf(plan.interval_minutes):
        return max(cfg.total_steps // 4, 1)
    return max(1, int(round(plan.interval_minutes / cfg.step_minutes)))


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device)


def _fresh_state(bundle: ModelBundle, seed: int, opt_cfg: OptimizerConfig,
                 device: torch.device) -> Dict[str, Any]:
    """``bundle.init(seed)``'s parameters (an :class:`LM` or a parameter
    dict) and zero optimizer state, on ``device``."""
    init = bundle.init(seed)
    params = (init.state_dict() if isinstance(init, nn.Module)
              else dict(init))
    params = {k: p.detach().to(device) for k, p in params.items()}
    return {"params": params, "opt": init_opt_state(params, opt_cfg)}


def _placed(built: BuiltStep, mesh, state: Dict[str, Any]
            ) -> Dict[str, Any]:
    """A whole state as the mesh holds it: this rank's parts on a mesh of
    ranks (the state is the caller's on one device)."""
    if isinstance(mesh, RankMesh):
        (state,) = built.place(state)
    return state


def _restored(built: BuiltStep, mesh, host_state) -> Dict[str, Any]:
    if isinstance(mesh, RankMesh):
        (state,) = built.place(host_state)
        return state
    return _to_device(host_state, mesh.device)


def _save(ckpt: AsyncCheckpointer, built: BuiltStep, mesh, step: int,
          state: Dict[str, Any]) -> None:
    """Checkpoint ``state`` at ``step``: on a mesh of ranks every rank
    gathers it and rank 0 writes it."""
    if isinstance(mesh, RankMesh):
        state = built.gather(state, built.in_shardings[0])
        if mesh.rank != 0:
            return
    ckpt.save(step, state, extra={"data_step": step})


def _wait(ckpt: AsyncCheckpointer, mesh) -> None:
    """Every pending write done (on a mesh, rank 0's, for every rank)."""
    ckpt.wait()
    if isinstance(mesh, RankMesh):
        mesh.barrier()


def train(bundle: ModelBundle, mesh, shape: ShapeSpec,
          loop_cfg: TrainLoopConfig,
          opt_cfg: OptimizerConfig = OptimizerConfig(),
          impl: Optional[str] = None) -> Dict[str, Any]:
    """Run the loop; returns history + recovery stats."""
    cfg = bundle.cfg
    built = make_train_step(bundle, mesh, shape, opt_cfg, impl)
    device = mesh.device

    pipeline = SyntheticTokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=shape.seq_len + 1,
        global_batch=shape.global_batch, seed=loop_cfg.seed))

    # ---- init or resume ---------------------------------------------------
    ckpt = AsyncCheckpointer(loop_cfg.checkpoint_dir,
                             keep=loop_cfg.keep_checkpoints)
    start_step = 0
    resume = latest_step(loop_cfg.checkpoint_dir)
    with mesh:
        if resume is not None:
            start_step, host_state, extra = restore_checkpoint(
                loop_cfg.checkpoint_dir)
            state = _restored(built, mesh, host_state)
            pipeline.seek(extra.get("data_step", start_step))
        else:
            state = _placed(built, mesh, _fresh_state(
                bundle, loop_cfg.seed, opt_cfg, device))
            pipeline.seek(0)

    injector = FailureInjector(
        loop_cfg.cluster, loop_cfg.step_minutes, seed=loop_cfg.seed + 1,
        deterministic_steps=loop_cfg.deterministic_failure_steps
    ) if loop_cfg.inject_failures else None
    stragglers = StragglerPolicy()
    stats = RecoveryStats()
    cadence = checkpoint_cadence(loop_cfg)

    history: List[Dict[str, float]] = []
    last_ckpt_step = start_step
    step = start_step
    t_loop = time.time()

    while step < loop_cfg.total_steps:
        batch_np = pipeline.with_frontend_stubs(pipeline.batch_at(step), cfg)
        batch = {k: torch.as_tensor(v).to(device)
                 for k, v in batch_np.items()}
        # truncate tokens/labels to seq_len (pipeline emits seq_len+1 grid)
        batch["tokens"] = batch["tokens"][:, :shape.seq_len]
        batch["labels"] = batch["labels"][:, :shape.seq_len]
        if isinstance(mesh, RankMesh):
            batch = sharding.place(batch, built.in_shardings[1], mesh)

        # ---- simulated failure? restore-from-checkpoint restart ----------
        if injector is not None and injector.check(step) is not None:
            stats.n_failures += 1
            t0 = time.time()
            _wait(ckpt, mesh)
            resume_step = latest_step(loop_cfg.checkpoint_dir)
            if resume_step is not None:
                _, host_state, extra = restore_checkpoint(
                    loop_cfg.checkpoint_dir)
                with mesh:
                    state = _restored(built, mesh, host_state)
                stats.lost_steps += step - resume_step
                step = resume_step
                pipeline.seek(extra.get("data_step", resume_step))
            else:  # no checkpoint yet: restart from scratch
                with mesh:
                    state = _placed(built, mesh, _fresh_state(
                        bundle, loop_cfg.seed, opt_cfg, device))
                stats.lost_steps += step
                step = 0
                pipeline.seek(0)
            stats.n_restores += 1
            stats.recovery_wall_s += time.time() - t0
            continue

        t0 = time.time()
        with mesh:
            state, metrics = built.fn(state, batch)
        loss = float(metrics["loss"])
        step_time = time.time() - t0
        if stragglers.observe(step_time):
            stats.straggler_mitigations += 1  # real fleet: evict + standby

        if not np.isfinite(loss):
            raise FloatingPointError(f"loss diverged at step {step}: {loss}")
        if step % loop_cfg.log_every == 0 or step == loop_cfg.total_steps - 1:
            history.append({"step": step, "loss": loss,
                            "grad_norm": float(metrics["grad_norm"]),
                            "lr": float(metrics["lr"]),
                            "step_time_s": step_time})
        step += 1

        if step - last_ckpt_step >= cadence:
            _save(ckpt, built, mesh, step, state)
            last_ckpt_step = step

    _save(ckpt, built, mesh, step, state)
    ckpt.close()
    if isinstance(mesh, RankMesh):
        mesh.barrier()
    return {
        "history": history,
        "final_loss": history[-1]["loss"] if history else float("nan"),
        "steps": step - start_step,
        "wall_s": time.time() - t_loop,
        "checkpoint_cadence": cadence,
        "recovery": stats.to_dict(),
        "stragglers": {"n": stragglers.n_stragglers,
                       "mitigations": stragglers.n_mitigations},
    }
