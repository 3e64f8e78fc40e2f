from .elastic import FailureEvent, WorkerPool
from .sharding import HostShardMap, WorkerShardMap

__all__ = ["FailureEvent", "HostShardMap", "WorkerPool", "WorkerShardMap"]
