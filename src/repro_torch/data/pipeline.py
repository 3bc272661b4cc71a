"""Deterministic, seekable synthetic token pipeline.

Counterpart of ``src/repro/data/pipeline.py``: numpy only, the same
splitmix64 counter mix, so every batch and frontend stub is bit for bit
the reference's.

Restart semantics are the point (the paper's recovery model): the stream
is a pure function of (seed, step, shard), so after a failure the loop
resumes at the exact step from the checkpointed cursor with no data loss
or duplication — the property AIReSim's recovery-time input assumes.

The generator is a counter-based PRF (threefry via jax.random under the
hood would be heavier than needed here; we use a splitmix64-style mix on
(seed, step, shard, position)), cheap enough to regenerate any batch at
any time on any host.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):  # wraparound is the point
        x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
        x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)).astype(np.uint64)
        x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)).astype(np.uint64)
        return x ^ (x >> np.uint64(31))


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1      # data-parallel shards
    shard_id: int = 0


class SyntheticTokenPipeline:
    """Yields {"tokens", "labels"} batches; O(1) seek to any step."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_shards:
            raise ValueError("global_batch must divide into shards")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_shards
        self._step = 0

    # -- seeking (restart support) ------------------------------------------
    @property
    def step(self) -> int:
        return self._step

    def seek(self, step: int) -> None:
        if step < 0:
            raise ValueError("negative step")
        self._step = step

    def state_dict(self) -> Dict[str, int]:
        return {"step": self._step, "seed": self.cfg.seed,
                "n_shards": self.cfg.n_shards, "shard_id": self.cfg.shard_id}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        if state["seed"] != self.cfg.seed:
            raise ValueError("seed mismatch on restore")
        self.seek(state["step"])

    # -- batch generation -----------------------------------------------------
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        B, S = self.local_batch, cfg.seq_len
        with np.errstate(over="ignore"):
            rows = (np.uint64(cfg.shard_id) * np.uint64(self.local_batch)
                    + np.arange(B, dtype=np.uint64))
            base = (np.uint64(cfg.seed) * np.uint64(0x5851F42D4C957F2D)
                    + np.uint64(step) * np.uint64(0x14057B7EF767814F))
            # one u64 stream per (row, position)
            pos = np.arange(S + 1, dtype=np.uint64)
            mix = _splitmix64(base + (rows[:, None] << np.uint64(20))
                              + pos[None, :])
        toks = (mix % np.uint64(cfg.vocab_size)).astype(np.int32)
        return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self.batch_at(self._step)
        self._step += 1
        return batch

    # -- frontend stubs ---------------------------------------------------------
    def with_frontend_stubs(self, batch: Dict[str, np.ndarray],
                            model_cfg) -> Dict[str, np.ndarray]:
        """Attach precomputed frame/patch embeddings for audio/vlm archs."""
        B = batch["tokens"].shape[0]
        step_seed = int(_splitmix64(np.uint64(self._step * 977 + 13)))
        rng = np.random.default_rng(step_seed % (2 ** 32))
        if model_cfg.is_encdec:
            batch["frames"] = rng.standard_normal(
                (B, model_cfg.encoder_seq, model_cfg.d_model),
                dtype=np.float32) * 0.1
        elif model_cfg.cross_attn_period > 0:
            batch["image_embeds"] = rng.standard_normal(
                (B, model_cfg.n_image_tokens, model_cfg.d_image),
                dtype=np.float32) * 0.1
        return batch
