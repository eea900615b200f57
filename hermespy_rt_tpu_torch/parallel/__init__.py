"""Multi-device tracing over ``torch.distributed``: meshes, ray- and
triangle-sharded traces, collectives."""
from .sharding import (default_mesh, trace_paths_sharded,
                       TriShardedSceneAccess, initialize_distributed)

__all__ = ["default_mesh", "trace_paths_sharded", "TriShardedSceneAccess",
           "initialize_distributed"]
