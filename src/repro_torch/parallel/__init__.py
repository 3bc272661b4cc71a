"""Distribution layer of the port: the sharding rules of the LM stack,
the sharding context of a mesh step, the step builders, and the replica
axis of the CTMC engines.

Counterpart of ``src/repro/parallel/``.  The step builders
(``steps.py``) import the models, whose layers read the sharding context
(``context.py``), so they load on first use.
"""

from .sharding import (REPLICA_AXIS, ParallelConfig, activation_spec,
                       batch_shardings, batch_spec, cache_shardings,
                       mesh_axes, opt_state_shardings, param_spec,
                       params_shardings, replica_mesh, replica_state_specs,
                       shard_seeds)

_STEPS = ("BuiltStep", "build_step", "input_specs", "make_decode_step",
          "make_prefill_step", "make_train_step", "param_specs",
          "state_specs")


def __getattr__(name):
    if name in _STEPS:
        from . import steps
        return getattr(steps, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["REPLICA_AXIS", "ParallelConfig", "activation_spec",
           "batch_shardings", "batch_spec", "cache_shardings", "mesh_axes",
           "opt_state_shardings", "param_spec", "params_shardings",
           "replica_mesh", "replica_state_specs", "shard_seeds", *_STEPS]
