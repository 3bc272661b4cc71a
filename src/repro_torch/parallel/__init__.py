"""Distribution layer of the port: the replica axis of the CTMC engines,
and the train step on one device.

Counterpart of the replica half of ``src/repro/parallel/sharding.py`` and
of ``make_train_step`` in ``src/repro/parallel/steps.py``.  The
parameter-spec half (tensor and data parallelism of the LM stack) is not
ported yet.
"""

from .sharding import (REPLICA_AXIS, replica_mesh, replica_state_specs,
                       shard_seeds)
from .steps import BuiltStep, make_train_step

__all__ = ["BuiltStep", "REPLICA_AXIS", "make_train_step", "replica_mesh",
           "replica_state_specs", "shard_seeds"]
