"""Distributed-systems layer of the port: the fault-tolerance primitives
the streaming scheduler rides (``RestartManager``, ``StragglerPolicy``),
the elastic re-mesh ``reshard_tree``, and the placements of the sharded
matcher's operands (``sharding``).  Collectives, compression and the
pipeline wait for ROADMAP A15."""

from .fault_tolerance import RestartManager, StragglerPolicy, reshard_tree
from .sharding import (doc_batch_spec, local_slices, matcher_chunk_specs,
                       matcher_lane_specs, matcher_table_specs)

__all__ = ["RestartManager", "StragglerPolicy", "reshard_tree",
           "matcher_table_specs", "matcher_chunk_specs", "matcher_lane_specs",
           "doc_batch_spec", "local_slices"]
