"""Kernels of the port: hand-written Hopper kernels beside their plain versions."""

from .ops import event_race
from .ref import event_race_ref

__all__ = ["event_race", "event_race_ref"]
