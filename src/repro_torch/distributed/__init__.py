"""The serving tier's distribution (PyTorch counterpart of
``repro.distributed``): fault-tolerance hooks (``fault``), the device mesh
(``mesh``) and sharded retrieval over it (``retrieval``). The training
partition rules (``sharding``, ROADMAP A, item 3) are not ported."""
from .fault import (
    HeartbeatRegistry,
    PreemptionGuard,
    ReplicaTracker,
    StepMonitor,
)
from .mesh import Mesh, make_mesh
from .retrieval import (
    ShardedRows,
    host_rows,
    shard_rows,
    sharded_ivf_probe,
    sharded_knn_search,
)

__all__ = [
    "HeartbeatRegistry",
    "Mesh",
    "PreemptionGuard",
    "ReplicaTracker",
    "ShardedRows",
    "StepMonitor",
    "host_rows",
    "make_mesh",
    "shard_rows",
    "sharded_ivf_probe",
    "sharded_knn_search",
]
