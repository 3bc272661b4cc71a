"""Replica sharding of the CTMC engines: devices, seeds and lane specs.

Counterpart of the replica half of ``src/repro/parallel/sharding.py``
(``REPLICA_AXIS``, ``replica_mesh``, ``shard_keys``,
``replica_state_specs``).  The reference splits the replica axis of a
batch over a ``shard_map`` mesh; the port gives each shard its own
device and drives the shards' chunked scans side by side
(``core.vectorized._run_sharded``): on the card shard ``s`` runs
on ``cuda:s``, one card a shard; on the CPU the shards run in turn on the
one host device.  There are no collectives: each shard's replicas are
independent, and concatenating the shards' replica axes is the merge.

Seeds take the place of the reference's threefry keys, whose bits torch
cannot reproduce: ``shard_seeds(seed, 1)`` is ``[seed]`` itself, so a
one-shard run is the unsharded run bit for bit, and ``n > 1`` shards get
seeds folded from ``(seed, s)``, so shard ``s`` of a sharded run is an
independent unsharded run over its replicas seeded ``shard_seeds(seed,
n)[s]``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

#: the replica-axis name; every batched lane of a CTMC state splits its
#: replica dimension over it
REPLICA_AXIS = "r"

def replica_mesh(n_shards: int, device) -> List[torch.device]:
    """The devices of an ``n_shards``-shard run on ``device``'s kind.

    On the card shard ``s`` runs on ``cuda:s`` (one shard on the caller's
    own device); more shards than ``torch.cuda.device_count()`` raise,
    naming both counts -- a sharded run never de-shards.  On the CPU the
    shards run in turn on the host device.

    >>> replica_mesh(2, "cpu")
    [device(type='cpu'), device(type='cpu')]
    >>> replica_mesh(0, "cpu")  # doctest: +IGNORE_EXCEPTION_DETAIL
    Traceback (most recent call last):
    ValueError: ...
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n_shards
    if n_shards == 1:
        return [device]
    visible = torch.cuda.device_count()
    if visible < n_shards:
        raise ValueError(
            f"replica mesh needs {n_shards} CUDA devices, one a shard, but "
            f"only {visible} are visible (torch.cuda.device_count()); "
            "lower engine_shards or run on a host with more cards")
    return [torch.device("cuda", s) for s in range(n_shards)]


def shard_seeds(seed: int, n_shards: int) -> List[int]:
    """One run seed a shard, for an ``n_shards``-shard run seeded ``seed``.

    ``n_shards == 1`` returns ``[seed]``; otherwise shard ``s``'s seed is
    a 64-bit hash of ``(seed, s)``: the state of the ``s``-th child that
    ``np.random.SeedSequence(seed).spawn`` gives, whose spawn key keeps it
    apart from a chunk's seed (``core.vectorized._chunk_seed`` hashes
    ``[seed, i]`` with none) and from an unsharded run's; it does not
    depend on ``n_shards``.

    >>> shard_seeds(7, 1)
    [7]
    >>> len(set(shard_seeds(7, 4)))
    4
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n_shards == 1:
        return [seed]
    seeds = [int(child.generate_state(1, np.uint64)[0]) for child in
             np.random.SeedSequence(seed % (1 << 64)).spawn(n_shards)]
    if len(set(seeds)) != n_shards:      # a 64-bit collision
        raise RuntimeError(f"shard seeds of seed {seed} collide: {seeds}")
    return seeds


def replica_state_specs(state: Dict[str, object],
                        unbatched: Iterable[str] = (),
                        ) -> Dict[str, Optional[str]]:
    """The axis each lane of a ``(P, R, ...)`` state splits over:
    :data:`REPLICA_AXIS` for a batched lane (its dimension 1), None for a
    lane named in ``unbatched`` (the shared bin edges), which every shard
    takes whole.

    >>> replica_state_specs({"t": None, "hist_edges": None},
    ...                     unbatched=("hist_edges",))
    {'t': 'r', 'hist_edges': None}
    """
    unbatched = set(unbatched)
    return {k: None if k in unbatched else REPLICA_AXIS for k in state}
