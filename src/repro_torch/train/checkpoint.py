"""Sharded checkpointing: per-host npz shards + manifest, async writes.

Counterpart of ``src/repro/train/checkpoint.py``, in its on-disk format
(the same flattened ``/`` paths, manifest, crc32 checksums and bit-cast
encoding of bfloat16 and float8 leaves), so either package reads the
other's directories.  Leaves go in as torch tensors or numpy arrays and
come back as CPU torch tensors; a JAX package's train state restored here
is carried to the port's names by
``repro_torch.models.train_state_from_jax``.

The mechanism AIReSim models (assumption: asynchronous checkpoints with
cheap steady-state overhead, expensive restart): the training loop hands a
state pytree to ``AsyncCheckpointer.save`` and keeps stepping while a
worker thread serializes.  Restores are synchronous (they gate the
restart, i.e. the paper's recovery_time).

Layout:
    <dir>/step_000123/
        manifest.json          # tree structure, shapes, dtypes, step
        shard_00000.npz        # flat {path: array} for this host's slice
On a mesh of ranks the training loop gathers the state and rank 0 writes
it as the one shard file, which a restore reads whole and places again
(``train.loop``).  Integrity: the
manifest carries per-leaf checksums (crc32 of a strided sample) verified
on load.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
import zlib
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, Any]


def _flatten(tree: Params, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k in sorted(tree.keys()):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Params:
    tree: Params = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _checksum(a: np.ndarray) -> int:
    sample = a.reshape(-1)[:: max(1, a.size // 4096)]
    return zlib.crc32(np.ascontiguousarray(sample).tobytes()) & 0xFFFFFFFF


#: dtypes numpy's npz round-trips as raw void — store bit-cast instead
_ENCODED_DTYPES = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8,
                   "float8_e5m2": np.uint8}
#: the integer torch dtype of each encoding's width
_TORCH_BITS = {np.uint16: torch.int16, np.uint8: torch.uint8}


def _encode(a) -> Tuple[np.ndarray, str]:
    """A leaf as the array npz stores, and its dtype's name."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
        name = str(t.dtype).replace("torch.", "")
        if name in _ENCODED_DTYPES:
            bits = _ENCODED_DTYPES[name]
            return t.view(_TORCH_BITS[bits]).numpy().view(bits), name
        return t.numpy(), name
    a = np.asarray(a)
    name = str(a.dtype)
    if name in _ENCODED_DTYPES:
        return a.view(_ENCODED_DTYPES[name]), name
    return a, name


def _decode(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype_name in _ENCODED_DTYPES:
        return t.view(_TORCH_BITS[_ENCODED_DTYPES[dtype_name]]).view(
            getattr(torch, dtype_name))
    return t


def save_checkpoint(directory: str, step: int, state: Params,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Synchronous sharded save; returns the checkpoint path."""
    path = os.path.join(directory, f"step_{step:09d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten(state)
    encoded = {p: _encode(a) for p, a in flat.items()}
    manifest = {
        "step": step,
        "extra": extra or {},
        "leaves": {p: {"shape": list(enc.shape), "dtype": dtype_name,
                       "crc32": _checksum(enc)}
                   for p, (enc, dtype_name) in encoded.items()},
        "format": 2,
    }
    np.savez(os.path.join(tmp, "shard_00000.npz"),
             **{p: enc for p, (enc, _) in encoded.items()})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)  # atomic publish
    return path


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       ) -> Tuple[int, Params, Dict[str, Any]]:
    """Load the given (or latest) checkpoint; verifies checksums.  The
    leaves come back as CPU torch tensors in their saved dtypes."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "shard_00000.npz")) as z:
        raw = {p: z[p] for p in z.files}
    flat = {}
    for p, meta in manifest["leaves"].items():
        if p not in raw:
            raise IOError(f"checkpoint missing leaf {p}")
        if _checksum(raw[p]) != meta["crc32"]:
            raise IOError(f"checksum mismatch at {p} — corrupt checkpoint")
        flat[p] = _decode(raw[p], meta["dtype"])
    return manifest["step"], _unflatten(flat), manifest.get("extra", {})


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _snapshot(tree):
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree, copy=True)


class AsyncCheckpointer:
    """Background-thread writer: training never blocks on serialization.

    ``save`` snapshots the (host-transferred) state and enqueues it; a
    single worker drains the queue.  ``wait`` barriers (used before exit
    and in tests).  Keeps the newest ``keep`` checkpoints.
    """

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._queue: "queue.Queue" = queue.Queue()
        self._error: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self.save_count = 0

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            step, state, extra = item
            try:
                save_checkpoint(self.directory, step, state, extra)
                self._gc()
            except BaseException as exc:  # surfaced on next save/wait
                self._error = exc
            finally:
                self._queue.task_done()

    def _gc(self) -> None:
        steps = sorted(s for s in (
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp")))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory,
                                       f"step_{s:09d}"), ignore_errors=True)

    def save(self, step: int, state: Params,
             extra: Optional[Dict[str, Any]] = None) -> None:
        if self._error:
            raise self._error
        # snapshot to host memory: the caller keeps stepping (and updates
        # its tensors in place) while the worker writes
        host_state = _snapshot(state)
        self._queue.put((step, host_state, extra))
        self.save_count += 1

    def wait(self) -> None:
        self._queue.join()
        if self._error:
            raise self._error

    def close(self) -> None:
        self.wait()
        self._queue.put(None)
        self._worker.join(timeout=10)
