"""Distributed-systems layer of the port: so far the fault-tolerance
primitives the streaming scheduler rides (``RestartManager``,
``StragglerPolicy``).  Sharding, collectives and elastic re-mesh wait for
ROADMAP A14."""

from .fault_tolerance import RestartManager, StragglerPolicy, reshard_tree

__all__ = ["RestartManager", "StragglerPolicy", "reshard_tree"]
