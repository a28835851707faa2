"""Distributed-systems layer of the port: the fault-tolerance primitives
the streaming scheduler rides (``RestartManager``, ``StragglerPolicy``),
the elastic re-mesh ``reshard_tree``, the placements of the LM's state and
of the sharded matcher's operands (``sharding``), the 2-tier collectives
(``collectives``), the int8 cross-pod compression (``compression``) and
the pipeline (``pipeline``), all on ``launch.mesh``'s meshes."""

from .fault_tolerance import RestartManager, StragglerPolicy, reshard_tree
from .sharding import (batch_specs, cache_specs, doc_batch_spec,
                       local_slices, matcher_chunk_specs, matcher_lane_specs,
                       matcher_table_specs, named, opt_state_specs,
                       param_specs, state_specs)

__all__ = ["RestartManager", "StragglerPolicy", "reshard_tree",
           "param_specs", "opt_state_specs", "batch_specs", "cache_specs",
           "state_specs", "named",
           "matcher_table_specs", "matcher_chunk_specs", "matcher_lane_specs",
           "doc_batch_spec", "local_slices"]
