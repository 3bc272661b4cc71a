"""Distribution layer of the port: the replica axis of the CTMC engines.

Counterpart of the replica half of ``src/repro/parallel/sharding.py``.
The parameter-spec half (tensor and data parallelism of the LM stack)
is not ported yet.
"""

from .sharding import (REPLICA_AXIS, replica_mesh, replica_state_specs,
                       shard_seeds)

__all__ = ["REPLICA_AXIS", "replica_mesh", "replica_state_specs",
           "shard_seeds"]
